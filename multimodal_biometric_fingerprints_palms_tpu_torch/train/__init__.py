"""Training of the port (the JAX package's ``train/``): schedules, the
optimizer chain optax supplies there, SSL and UNet++ training."""

from .schedule import cosine_warmup_schedule
from .ssl_train import SSLTrainState, create_ssl_train_step, train_ssl
