"""Composed-YAML configuration (``gotennet_tpu/utils/config.py``).

  * group composition: the root config's ``defaults`` names one YAML per
    group directory (model/, datamodule/, trainer/);
  * experiment overlays: ``experiment=<name>`` deep-merges
    ``experiment/<name>.yaml`` over the whole tree;
  * dotted overrides: ``model.representation.lmax=3``, values read as YAML
    scalars (``lr=1e-5`` is a float, ``edge_updates=true`` a bool);
  * ``${path.in.tree}`` interpolation and ``${oc.env:VAR,default}`` /
    ``${env:VAR}`` from the environment.

PyYAML is not needed: ``yaml_load`` reads the subset of YAML the config
files use (block mappings, ``- item`` and ``- key: value`` lists, flow
lists and mappings of scalars, comments, quoted and plain scalars) with
YAML 1.1's rules for null, bool, int and float, as ``yaml.safe_load``
resolves them.
"""

from __future__ import annotations

import copy
import math
import os
import re
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["load_config", "merge", "apply_overrides", "resolve", "yaml_load",
           "parse_scalar"]

_INTERP = re.compile(r"\$\{([^}]+)\}")

# YAML 1.1 implicit types, as PyYAML's resolver has them
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
# bare scientific notation ('3e-4'), a string to YAML 1.1, read as a float
# in overrides
_SCI_FLOAT = re.compile(r"[-+]?(\d+\.?\d*|\.\d+)[eE][-+]?\d+")


def _sexagesimal(body: str, conv) -> Any:
    value = 0
    for part in body.split(":"):
        value = value * 60 + conv(part)
    return value


def _plain_scalar(text: str) -> Any:
    """A plain (unquoted) scalar under YAML 1.1's implicit types."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        if v[0] in "+-":
            v = v[1:]
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return sign * _sexagesimal(v, int)
        return sign * int(v)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        if v[0] in "+-":
            v = v[1:]
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    return text


def _quoted(text: str, i: int) -> Tuple[str, int]:
    """The quoted scalar starting at ``text[i]``: (value, index after it)."""
    q = text[i]
    out, j = [], i + 1
    while j < len(text):
        c = text[j]
        if q == "'" and c == "'":
            if text[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            nxt = text[j + 1]
            out.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\",
                        "/": "/", "0": "\0"}.get(nxt, "\\" + nxt))
            j += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), j + 1
        out.append(c)
        j += 1
    raise ValueError(f"unterminated quoted scalar: {text!r}")


def _strip_comment(line: str) -> str:
    """``line`` without a trailing comment (a ``#`` at the start or after
    whitespace, outside quotes)."""
    q = None
    for i, c in enumerate(line):
        if q:
            if c == q:
                q = None
        elif c in "\"'" and (i == 0 or line[i - 1] in " \t:[{,-"):
            q = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_flow(body: str) -> List[str]:
    parts, depth, q, cur = [], 0, None, []
    for c in body:
        if q:
            q = None if c == q else q
        elif c in "\"'":
            q = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        elif c == "," and depth == 0:
            parts.append("".join(cur).strip())
            cur = []
            continue
        cur.append(c)
    if "".join(cur).strip():
        parts.append("".join(cur).strip())
    return parts


def _key_value(text: str) -> Optional[Tuple[Any, str]]:
    """``(key, rest)`` where ``text`` is ``key: rest`` (or ``key:``), else
    None."""
    if text[:1] in "\"'":
        key, j = _quoted(text, 0)
        rest = text[j:]
        if rest.startswith(":") and (len(rest) == 1 or rest[1] in " \t"):
            return key, rest[1:].strip()
        return None
    for m in re.finditer(r":(?=\s|$)", text):
        key = text[:m.start()].strip()
        if key and not key.startswith(("[", "{")):
            return _plain_scalar(key), text[m.end():].strip()
        return None
    return None


def _value(text: str) -> Any:
    """An inline value: a quoted or plain scalar, or a flow collection."""
    text = text.strip()
    if not text:
        return None
    if text[0] in "\"'":
        value, j = _quoted(text, 0)
        if text[j:].strip():
            raise ValueError(f"text after a quoted scalar: {text!r}")
        return value
    if text[0] == "[" and text[-1] == "]":
        return [_value(p) for p in _split_flow(text[1:-1])]
    if text[0] == "{" and text[-1] == "}":
        out = {}
        for p in _split_flow(text[1:-1]):
            kv = _key_value(p) or (_plain_scalar(p), "")
            out[kv[0]] = _value(kv[1])
        return out
    if text[0] in "&*!|>%@`":
        raise ValueError(f"YAML feature outside the supported subset: "
                         f"{text!r}")
    return _plain_scalar(text)


def yaml_load(text: str) -> Any:
    """Parse a YAML document of the supported subset (see the module
    docstring); an empty document gives None."""
    lines = []
    for raw in text.splitlines():
        if raw.strip() in ("---", "..."):
            continue
        line = _strip_comment(raw.replace("\t", "    "))
        if line.strip():
            lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return None
    first = lines[0][1]
    if len(lines) == 1 and not (first.startswith("- ") or first == "-"
                                or _key_value(first) is not None):
        return _value(first)
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unexpected indentation at {lines[i][1]!r}")
    return value


def _block(lines, i: int, indent: int) -> Tuple[Any, int]:
    """The block node whose lines start at ``lines[i]`` with ``indent``."""
    if lines[i][1].startswith("- ") or lines[i][1] == "-":
        out = []
        while i < len(lines) and lines[i][0] == indent and (
                lines[i][1].startswith("- ") or lines[i][1] == "-"):
            item = lines[i][1][1:].strip()
            inner = indent + 1 + (len(lines[i][1][1:]) -
                                  len(lines[i][1][1:].lstrip(" ")))
            if not item:
                i += 1
                if i < len(lines) and lines[i][0] > indent:
                    value, i = _block(lines, i, lines[i][0])
                else:
                    value = None
                out.append(value)
                continue
            if _key_value(item) is not None:
                # a mapping item: its first key on the dash's line, any
                # further keys below it at the same column
                lines = lines[:i] + [(inner, item)] + lines[i + 1:]
                value, i = _block(lines, i, inner)
                out.append(value)
                continue
            out.append(_value(item))
            i += 1
        return out, i
    out: Dict[Any, Any] = {}
    while i < len(lines) and lines[i][0] == indent:
        kv = _key_value(lines[i][1])
        if kv is None:
            raise ValueError(f"expected 'key: value', got {lines[i][1]!r}")
        key, rest = kv
        i += 1
        if rest:
            out[key] = _value(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and lines[i][1].startswith("- "))):
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


def parse_scalar(raw: str) -> Any:
    """An override's value: YAML, and bare scientific notation ('3e-4')
    as a float."""
    value = yaml_load(raw)
    if isinstance(value, str) and _SCI_FLOAT.fullmatch(value.strip()):
        return float(value)
    return value


def merge(base: Dict, overlay: Dict) -> Dict:
    """Recursive dict merge; overlay wins, dicts merge, others replace."""
    out = copy.deepcopy(base)
    for k, v in overlay.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _get_path(tree: Dict, dotted: str):
    node = tree
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            raise KeyError(dotted)
        node = node[part]
    return node


def _set_path(tree: Dict, dotted: str, value) -> None:
    parts = dotted.split(".")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def apply_overrides(cfg: Dict, overrides: List[str]) -> Dict:
    """Apply ``key.path=value`` strings; values parsed by ``parse_scalar``."""
    cfg = copy.deepcopy(cfg)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must be key=value")
        key, _, raw = ov.partition("=")
        _set_path(cfg, key.strip(), parse_scalar(raw))
    return cfg


def resolve(cfg: Dict) -> Dict:
    """Resolve ``${path.in.tree}`` and ``${env:VAR}`` interpolations."""
    def subst(value, root):
        if isinstance(value, str):
            m = _INTERP.fullmatch(value)
            if m:  # whole-string interpolation keeps the native type
                return lookup(m.group(1), root)
            return _INTERP.sub(lambda mm: str(lookup(mm.group(1), root)),
                               value)
        if isinstance(value, dict):
            return {k: subst(v, root) for k, v in value.items()}
        if isinstance(value, list):
            return [subst(v, root) for v in value]
        return value

    def lookup(expr: str, root):
        if expr.startswith(("oc.env:", "env:")):
            var = expr.split(":", 1)[1]
            name, _, default = var.partition(",")
            return os.environ.get(name.strip(), default.strip() or None)
        return _get_path(root, expr)

    prev = None
    out = cfg
    for _ in range(8):  # nested interpolations
        if out == prev:
            break
        prev = out
        out = subst(out, out)
    return out


def load_config(config_dir: str, root: str = "train.yaml",
                overrides: Optional[List[str]] = None) -> Dict:
    """Compose a config tree from ``config_dir``: the root YAML's
    ``defaults`` (``- group: name`` loads ``<group>/<name>.yaml`` into key
    ``group``), then ``experiment=<name>`` deep-merged over the tree, then
    the other dotted overrides, then interpolation.  ``_overrides`` lists
    the keys the overrides set."""
    overrides = list(overrides or [])

    def read(p):
        with open(p) as f:
            return yaml_load(f.read()) or {}

    cfg = read(os.path.join(config_dir, root))
    defaults = cfg.pop("defaults", [])
    for entry in defaults:
        if isinstance(entry, str):
            group, name = entry.split("/", 1) if "/" in entry else (entry, None)
        else:
            (group, name), = entry.items()
        if name is None:
            continue
        path = os.path.join(config_dir, group, f"{name}.yaml")
        cfg[group] = merge(cfg.get(group, {}), read(path))

    exp = None
    rest = []
    for ov in overrides:
        if ov.startswith("experiment="):
            exp = ov.split("=", 1)[1]
        else:
            rest.append(ov)
    if exp:
        cfg = merge(cfg, read(os.path.join(config_dir, "experiment",
                                           f"{exp}.yaml")))
    if rest:
        cfg = apply_overrides(cfg, rest)
    cfg = resolve(cfg)
    cfg["_overrides"] = sorted(ov.partition("=")[0].strip() for ov in rest)
    return cfg
