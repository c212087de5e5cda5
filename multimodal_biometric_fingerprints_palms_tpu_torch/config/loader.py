"""Config system of the port: ``ConfigNode`` and the four ``load_*_config``
functions of the JAX package's ``config/loader.py``, over the same
``configs/*.yml`` files.

The port parses them with its own reader of the YAML subset those files use
(the card's machine has no PyYAML, and the port imports none): block
mappings indented by spaces, plain and quoted scalars resolved as PyYAML's
``safe_load`` resolves them (YAML 1.1: ``yes``/``on`` are booleans, a float
needs a dot), flow lists of scalars, and comments. Anything else (block
sequences, flow mappings, multi-line strings, anchors, tags, several
documents, duplicate keys, integers in other bases, timestamps) raises
``YamlSubsetError``: the reader never guesses.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Mapping


class YamlSubsetError(ValueError):
    """YAML the port's reader does not parse."""


class ConfigNode(Mapping):
    """Immutable-ish attribute/dict hybrid view over nested YAML.

    Supports ``cfg.ransac.max_iterations``, ``cfg["ransac"]["max_iterations"]``
    and dotted ``cfg.get("ransac.max_iterations", default)``.
    """

    def __init__(self, data: dict[str, Any]):
        object.__setattr__(self, "_data", dict(data))

    def __getitem__(self, key: str) -> Any:
        val = self._data[key]
        return ConfigNode(val) if isinstance(val, dict) else val

    def __iter__(self):
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def get(self, key: str, default: Any = None) -> Any:
        """Dotted-path lookup: ``cfg.get("ransac.seed", 42)``."""
        node: Any = self._data
        for part in key.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return ConfigNode(node) if isinstance(node, dict) else node

    def to_dict(self) -> dict[str, Any]:
        return dict(self._data)

    def __repr__(self) -> str:
        return f"ConfigNode({self._data!r})"


# --- the YAML subset ----------------------------------------------------------

# PyYAML's implicit resolvers (resolver.py), YAML 1.1
_BOOL = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False,
         "NO": False, "true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False, "on": True,
         "On": True, "ON": True, "off": False, "Off": False, "OFF": False}
_NULL = {"~", "null", "Null", "NULL", ""}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_INT_OTHER = re.compile(
    r"[-+]?0b[0-1_]+$|[-+]?0[0-7_]+$|[-+]?0x[0-9a-fA-F_]+$"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+$")
_FLOAT = re.compile(
    r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?$")
_FLOAT_SEXAGESIMAL = re.compile(r"[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*$")
_FLOAT_SPECIAL = {".inf": float("inf"), ".Inf": float("inf"),
                  ".INF": float("inf"), "+.inf": float("inf"),
                  "+.Inf": float("inf"), "+.INF": float("inf"),
                  "-.inf": float("-inf"), "-.Inf": float("-inf"),
                  "-.INF": float("-inf"), ".nan": float("nan"),
                  ".NaN": float("nan"), ".NAN": float("nan")}
_TIMESTAMP = re.compile(r"[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_\-]*$")


def _plain(text: str, where: str) -> Any:
    """A plain scalar resolved as PyYAML's ``safe_load`` would."""
    if text in _BOOL:
        return _BOOL[text]
    if text in _NULL:
        return None
    if _INT.match(text):
        return int(text.replace("_", ""))
    if text in _FLOAT_SPECIAL:
        return _FLOAT_SPECIAL[text]
    if _FLOAT.match(text):
        if "_" in text:
            raise YamlSubsetError(f"{where}: float with underscores {text!r}")
        return float(text)
    if (_INT_OTHER.match(text) or _FLOAT_SEXAGESIMAL.match(text)
            or _TIMESTAMP.match(text) or text in ("=", "<<")):
        raise YamlSubsetError(f"{where}: unsupported scalar {text!r}")
    if text[0] in "[]{}&*!|>'\"%@`#,?:-" or ": " in text or text.endswith(":"):
        raise YamlSubsetError(f"{where}: unsupported value {text!r}")
    return text


def _quoted(text: str, where: str) -> tuple[str, str]:
    """(the string, what follows it) of a quoted scalar at ``text``'s
    start: single quotes with '' for a quote, double quotes without
    escapes."""
    q = text[0]
    i, out = 1, []
    while i < len(text):
        c = text[i]
        if c == q:
            if q == "'" and text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if q == '"' and c == "\\":
            raise YamlSubsetError(f"{where}: escapes in double quotes")
        out.append(c)
        i += 1
    raise YamlSubsetError(f"{where}: unterminated quoted scalar")


def _strip_comment(rest: str, where: str) -> str:
    rest = rest.strip()
    if rest.startswith("#"):
        return ""
    m = re.search(r"\s#", rest)
    return (rest[:m.start()] if m else rest).strip()


def _value(text: str, where: str) -> Any:
    """The value after ``key:`` on one line (comment included)."""
    text = text.strip()
    if text[:1] in ("'", '"'):
        s, rest = _quoted(text, where)
        if _strip_comment(rest, where):
            raise YamlSubsetError(f"{where}: text after a quoted scalar")
        return s
    text = _strip_comment(text, where)
    if text.startswith("["):
        if not text.endswith("]"):
            raise YamlSubsetError(f"{where}: flow list not closed on its line")
        inner = text[1:-1].strip()
        if not inner:
            return []
        items = []
        for item in inner.split(","):
            item = item.strip()
            if item[:1] in ("'", '"'):
                s, rest = _quoted(item, where)
                if rest.strip():
                    raise YamlSubsetError(f"{where}: bad flow list item")
                items.append(s)
            elif not item or item[0] in "[{" or ": " in item:
                raise YamlSubsetError(f"{where}: unsupported flow list item")
            else:
                items.append(_plain(item, where))
        return items
    return _plain(text, where)


def parse_yaml_subset(text: str, name: str = "<yaml>") -> dict:
    """The mapping a config file holds; raises ``YamlSubsetError`` for
    anything outside the subset."""
    lines = []
    for n, raw in enumerate(text.splitlines(), start=1):
        where = f"{name}:{n}"
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise YamlSubsetError(f"{where}: tab in indentation")
        body = raw.strip()
        if not body or body.startswith("#"):
            continue
        if body in ("---", "...") or body.startswith("%"):
            raise YamlSubsetError(f"{where}: documents and directives")
        if body.startswith("- ") or body == "-":
            raise YamlSubsetError(f"{where}: block sequences")
        lines.append((len(raw) - len(raw.lstrip(" ")), body, where))

    root: dict = {}
    stack = [(-1, root)]              # (indent of the mapping's keys, dict)
    pending = None                    # (indent, dict, key) awaiting a block
    for indent, body, where in lines:
        if pending is not None:
            p_indent, p_map, p_key = pending
            pending = None
            if indent > p_indent:
                child: dict = {}
                p_map[p_key] = child
                stack.append((indent, child))
            else:
                p_map[p_key] = None
        while indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            if stack[-1][0] == -1 and stack[-1][1] is root and not root:
                stack[-1] = (indent, root)
            else:
                raise YamlSubsetError(f"{where}: bad indentation")
        m = re.match(r"([^:#'\"]+?):(?:\s+(.*))?$", body)
        if not m:
            raise YamlSubsetError(f"{where}: not a 'key: value' line")
        key, rest = m.group(1), m.group(2) or ""
        if not _KEY.match(key) or key in _BOOL or key in _NULL:
            raise YamlSubsetError(f"{where}: unsupported key {key!r}")
        mapping = stack[-1][1]
        if key in mapping:
            raise YamlSubsetError(f"{where}: duplicate key {key!r}")
        if not _strip_comment(rest, where) and rest.strip()[:1] not in ("'", '"'):
            pending = (indent, mapping, key)
            mapping[key] = None
            continue
        mapping[key] = _value(rest, where)
    return root


# --- loading ------------------------------------------------------------------

def _repo_root() -> Path:
    return Path(__file__).resolve().parents[2]


def load_yaml_config(path: str | Path) -> ConfigNode:
    path = Path(path)
    if not path.is_absolute():
        path = _repo_root() / path
    return ConfigNode(parse_yaml_subset(path.read_text(), str(path)))


def _resolve_paths(cfg: dict[str, Any], root: Path) -> dict[str, Any]:
    """Absolutize ``./``-relative entries under a ``paths`` section."""
    paths = cfg.get("paths")
    if isinstance(paths, dict):
        root_dir = Path(paths.get("root_dir", root))
        if not root_dir.is_absolute():
            root_dir = root / root_dir
        for k, v in list(paths.items()):
            if isinstance(v, str) and v.startswith("./"):
                paths[k] = str(root_dir / v[2:])
        paths["root_dir"] = str(root_dir)
    return cfg


def _load(named_default: str, path: str | Path | None) -> ConfigNode:
    cfg_path = Path(path) if path else _repo_root() / "configs" / named_default
    cfg = load_yaml_config(cfg_path)
    data = _resolve_paths(cfg.to_dict(), _repo_root())
    return ConfigNode(data)


def load_fingerprint_config(path: str | Path | None = None) -> ConfigNode:
    """Preprocessing/binarization/orientation params."""
    return _load("config_fingerprint.yml", path)


def load_classifier_config(path: str | Path | None = None) -> ConfigNode:
    """SSL classifier params."""
    return _load("config_classifier.yml", path)


def load_matching_config(path: str | Path | None = None) -> ConfigNode:
    """Matching/RANSAC/eval params."""
    return _load("config_matching.yml", path)


def load_segmentation_config(path: str | Path | None = None) -> ConfigNode:
    """UNet++ segmentation training params."""
    return _load("config_segmentation.yml", path)


def print_config_summary(cfg: ConfigNode, title: str = "config") -> None:
    """Console dump of a config tree."""
    print(f"===== {title} =====")

    def walk(node, indent=0):
        for k in node:
            v = node[k]
            if isinstance(v, ConfigNode):
                print("  " * indent + f"{k}:")
                walk(v, indent + 1)
            else:
                print("  " * indent + f"{k}: {v}")

    walk(cfg)
