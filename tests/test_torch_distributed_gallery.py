"""The port's gallery (``parallel/gallery.py``) sharded over 2 and 4 gloo
ranks on the CPU, against the port on one device and against the JAX
package on a 2- and 4-device mesh of ``tests/conftest.py``'s virtual CPU
devices.

Every rank runs every function once (``torch_dist_workers.gallery_calls``) in one launch of
``parallel.launch.run_ranks`` a rank count, under the launch's own time
limit; the one-device results come from the same function in this
process. Tolerances, with their reasons:

- every rank's result equals the one-device result exactly: a pair's score
  depends on the pair alone, not on the call or the rank that scores it;
- scores against the JAX functions (``use_pallas=False``): 1e-4, the bound
  of ``tests/test_torch_gallery.py``;
- promote bits against the JAX functions run with their accelerator rule
  (the Pallas screen in interpret mode, patched in for the call, OR-ed
  with the anchors): exact. The JAX package's CPU route screens with the
  full matcher, another rule;
- the cascade over N=70 (the padded block case; its screen is 3 tiles of
  4,096 pairs, too many for the Pallas interpreter): zero where the port's
  one-device screen drops a pair, else within 1e-4 of the JAX package's
  cascade-off score on the same mesh.

Templates are K=16 (``utils.synthetic.users_gallery`` with 16 minutiae),
RANSAC 16: the plain twin's temporaries grow with K * K.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from multimodal_biometric_fingerprints_palms_tpu.features.minutiae import (
    MinutiaeSet as JSet)
from multimodal_biometric_fingerprints_palms_tpu.matching import (
    pallas_match as jpm, ransac as jr)
from multimodal_biometric_fingerprints_palms_tpu.parallel import (
    gallery as jg, mesh as jmesh)
from multimodal_biometric_fingerprints_palms_tpu_torch.parallel import (
    launch, mesh as tmesh)
from torch_dist_workers import (PARAMS, SCREEN, gallery_calls, gallery_rank,
                                n16, n70, pairs37)

torch.set_num_threads(1)

SCORE_ATOL = 1e-4
LAUNCH_S = 240.0            # one launch runs every call below


@functools.cache
def _one_device() -> dict:
    return gallery_calls(tmesh.create_mesh(device="cpu"))


@functools.cache
def _ranks(w: int) -> list:
    return launch.run_ranks(gallery_rank, w, device="cpu",
                            timeout=LAUNCH_S)


CALLS = ["all_pairs_scores", "shard_pairs_scores", "shard_pairs_screen",
         "shard_blocks_screen", "all_pairs_unique", "all_pairs_unique cascade",
         "identify", "identify_batch"]


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("call", CALLS)
def test_every_rank_equals_one_device(w, call):
    want = _one_device()[call]
    results = _ranks(w)
    assert len(results) == w
    for rank, got in enumerate(results):
        assert got[call].shape == want.shape, (rank, call)
        np.testing.assert_array_equal(got[call], want, err_msg=f"rank {rank}")


# --- against the JAX package on a mesh of as many devices --------------------

def _jset(d) -> JSet:
    return JSet(**{f: jax.numpy.asarray(v) for f, v in d.items()})


@functools.cache
def _jax_calls(w: int) -> dict:
    mesh = jmesh.create_mesh(w)
    p, sp = jr.MatchParams(**PARAMS), jr.MatchParams(**SCREEN)
    j16, j70 = _jset(n16()), _jset(n70())
    probes = jax.tree.map(lambda x: x[np.array([1, 6, 13])], j16)
    return {
        "all_pairs_scores": np.asarray(jg.all_pairs_scores(
            jg.shard_gallery(j16, mesh), mesh, p, col_chunk=8)),
        "shard_pairs_scores": np.stack(jg.shard_pairs_scores(
            j16, pairs37(), mesh, p, chunk=8,
            use_pallas=False)).astype(np.float64),
        "all_pairs_unique": np.asarray(jg.all_pairs_unique(
            j70, mesh, p, chunk=512, cascade=False, use_pallas=False)),
        "identify": np.asarray(jg.identify(
            jax.tree.map(lambda x: x[6], j16), jg.shard_gallery(j16, mesh),
            mesh, p, chunk=4, use_pallas=False)),
        "identify_batch": np.asarray(jg.identify_batch(
            probes, jg.shard_gallery(j16, mesh), mesh, p, chunk=4,
            use_pallas=False)),
    }


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("call", ["all_pairs_scores", "shard_pairs_scores",
                                  "all_pairs_unique", "identify",
                                  "identify_batch"])
def test_ranks_match_jax_scores(w, call):
    want = _jax_calls(w)[call]
    got = _ranks(w)[0][call]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL)


@pytest.mark.parametrize("w", [2, 4])
def test_ranks_cascade_is_jax_full_pass_where_promoted(w):
    got = _ranks(w)[0]["all_pairs_unique cascade"]
    full = _jax_calls(w)["all_pairs_unique"]
    kept = got != 0
    assert 0 < kept.sum() < kept.size
    np.testing.assert_allclose(got[kept], full[kept], atol=SCORE_ATOL)
    np.testing.assert_array_equal(got, _one_device()["all_pairs_unique cascade"])


@pytest.fixture()
def pallas_screen(monkeypatch):
    """The JAX screen's accelerator rule on the CPU: its Pallas kernel in
    interpret mode."""
    monkeypatch.setattr(jpm, "screen_pairs_batch_pallas", functools.partial(
        jpm.screen_pairs_batch_pallas, interpret=True))


@pytest.mark.parametrize("w", [2, 4])
def test_ranks_pair_screen_matches_jax_accelerator_rule(w, pallas_screen):
    mesh = jmesh.create_mesh(w)
    want = np.asarray(jg.shard_pairs_screen(
        _jset(n16()), pairs37(), mesh, jr.MatchParams(**SCREEN), chunk=8,
        use_pallas=True))
    got = _ranks(w)[0]["shard_pairs_screen"]
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size


@pytest.mark.parametrize("w", [2, 4])
def test_ranks_blocks_screen_matches_jax_accelerator_rule(w, pallas_screen):
    mesh = jmesh.create_mesh(w)
    bp, mask = jg.shard_blocks_screen(_jset(n16()), mesh,
                                      jr.MatchParams(**SCREEN), block=8,
                                      use_pallas=True)
    got = _ranks(w)[0]["shard_blocks_screen"]
    np.testing.assert_array_equal(
        got, np.concatenate([bp.ravel(), np.asarray(mask).ravel()]))
