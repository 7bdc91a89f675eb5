"""Three-tier hyperparameter config: defaults → YAML overlay → CLI overrides
(port of ``qat_vit_tpu/train/config.py``: framework-free).

The same ``DEFAULT_HPARAMS`` as the JAX package, so one ``best_params.yaml``
configures either trainer; :func:`add_hparam_flags` gives the same flags.
The YAML is flat (one ``key: scalar`` per line), so the port reads and
writes it itself, without ``pyyaml``: :func:`dump_flat_yaml` emits the bytes
``yaml.safe_dump(hp, sort_keys=True)`` emits for a flat mapping of ``str``,
``int``, ``float``, ``bool`` and ``None`` values (strings of printable
ASCII), and :func:`load_flat_yaml` reads them back as ``yaml.safe_load``
does; anything else (nesting, flow style, anchors, tags, other scalars) is
refused with a ``ValueError`` naming the line.
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import re
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

# The reference's DEFAULT_HPARAMS (qat_trainer.py:36-46) + the JAX package's
# additions, value for value (the JAX file documents each one). Keys the port
# does not act on yet are kept so one YAML configures either trainer.
DEFAULT_HPARAMS: Dict[str, Any] = {
    "lr": 1.5e-4,
    "weight_decay": 1e-3,
    "label_smoothing": 0.1,
    "kd_temperature": 4.0,
    "kd_alpha": 0.5,
    "qat_start_epoch": 2,
    "epochs": 10,
    "batch_size": 256,
    "qat_backend": "qnnpack",
    "qat_lr_scale": 0.5,  # LR x 0.5 at the QAT switch
    "amp": True,  # bf16 float phase
    "grad_clip_norm": 1.0,
    "seed": 0,
    "image_size": 224,
    "num_classes": 10,
    "eval_batch_size": 512,
    "model_parallel": 1,
    "data_dir": "./data",
    "output_dir": "./qat_output",
    "mlflow_uri": "sqlite:///mlflow.db",
    "experiment": "clue-vit-qat-final",
    "student_family": "vit",
    "limit_train_batches": 0,  # 0 = full epoch
    "limit_eval_batches": 0,
    "resume": "",
    "save_resume_state": True,
    "teacher_ckpt": "",
    "student_ckpt": "",
    "cache_teacher_logits": True,  # the frozen teacher's logits, once per dataset
    "qat_amp": True,  # bf16 matmuls under fake-quant
    "amp_fast_math": True,  # bf16 softmax + tanh-GELU in the bf16 phases
    "observer_interval": 1,
    "observer_stride": 1,
    "progress_bar": False,
    "remat": "none",
    "fq_in_kernel": True,  # the qkv fake-quant inside the attention kernels
    "per_channel_weights": False,
    "profile_dir": "",
    "task": "classification",
    "det_box_weight": 1.0,
    "det_obj_weight": 0.25,
    "num_queries": 4,
    "text_dim": 512,
    # the detection queries' seed (-1: the run's seed); the JAX detection
    # trainer reads it with the same default
    "query_seed": -1,
}

_TYPES = {k: type(v) for k, v in DEFAULT_HPARAMS.items()}

# Reference key spellings accepted on YAML load (the reference's optuna search
# and DEFAULT_HPARAMS call the distillation temperature ``kd_temp``,
# optuna_search.py:135 / qat_trainer.py:40) — a reference-produced
# best_params.yaml must feed this trainer without silent fallback to defaults.
_ALIASES = {"kd_temp": "kd_temperature"}


def _cast(key: str, value: Any) -> Any:
    """Type-normalize a YAML/CLI value to the default's type (ref :87-96)."""
    t = _TYPES.get(key)
    if t is None or value is None:
        return value
    if t is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "on")
    try:
        return t(value)
    except (TypeError, ValueError):
        logger.warning("could not cast hparam %s=%r to %s; keeping raw", key, value, t)
        return value


# ---------------------------------------------------------------------------
# flat YAML, as PyYAML's safe_dump writes it and safe_load reads it
# ---------------------------------------------------------------------------

# YAML 1.1's implicit tags of plain scalars (PyYAML's resolver), keyed by the
# first character; the first pattern that matches gives the tag
_RESOLVERS = [
    ("bool", re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                        r"|on|On|ON|off|Off|OFF)$"), "yYnNtTfFoO"),
    ("float", re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                         r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                         r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                         r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$"), "-+0123456789."),
    ("int", re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                       r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$"),
     "-+0123456789"),
    ("merge", re.compile(r"^(?:<<)$"), "<"),
    ("null", re.compile(r"^(?:~|null|Null|NULL|)$"), "~nN"),
    ("timestamp", re.compile(
        r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
        r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?(?:[Tt]|[ \t]+)[0-9][0-9]?"
        r":[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$"),
     "0123456789"),
    ("value", re.compile(r"^(?:=)$"), "="),
    ("yaml", re.compile(r"^(?:!|&|\*)$"), "!&*"),
]
_WIDTH, _INDENT = 80, 2  # the emitter's best_width and best_indent
# a longer key (with its tag's 5 characters, 128) is written as "? key"
_SIMPLE_KEY = 123
_BOOLS = {"yes": True, "no": False, "true": True, "false": False, "on": True, "off": False}


def _resolve(text: str) -> str:
    """The implicit tag of ``text`` as a plain scalar."""
    for tag, pattern, first in _RESOLVERS:
        if (text[:1] in first if text else tag == "null") and pattern.match(text):
            return tag
    return "str"


def _plain_ok(text: str) -> bool:
    """PyYAML's ``analyze_scalar`` for printable ASCII, block context: may
    ``text`` be written plain? (No leading or trailing space, no indicator
    at the start, no ``: `` or `` #`` inside, no document marker.)"""
    if not text or text[0] == " " or text[-1] == " " or text.startswith(("---", "...")):
        return False
    for i, ch in enumerate(text):
        followed = i + 1 >= len(text) or text[i + 1] == " "
        if i == 0:
            if ch in "#,[]{}&*!|>'\"%@`" or (ch in "?:-" and followed):
                return False
        elif (ch == ":" and followed) or (ch == "#" and text[i - 1] == " "):
            return False
    return True


def _scalar(value: Any, key: str) -> tuple:
    """(text, quoted) of a value as the representer and emitter choose."""
    if value is None:
        return "null", False
    if isinstance(value, bool):
        return ("true" if value else "false"), False
    if isinstance(value, int):
        return str(value), False
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan", False
        if math.isinf(value):
            return (".inf" if value > 0 else "-.inf"), False
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text, False
    if isinstance(value, str):
        if any(not " " <= ch <= "~" for ch in value):
            raise ValueError(f"flat YAML: {key!r} holds a character outside printable ASCII")
        return value, not (_resolve(value) == "str" and _plain_ok(value))
    raise ValueError(f"flat YAML: {key!r} is a {type(value).__name__}, not a scalar")


def _emit(text: str, quoted: bool, column: int, split: bool) -> str:
    """A scalar written after ``column`` characters: plain or single-quoted,
    folded at single inner spaces past column 80 onto lines indented by 2,
    as PyYAML's ``write_plain`` / ``write_single_quoted`` fold."""
    out = [" '" if quoted else " "]
    column += len(out[0])
    pieces = re.findall(r" +|[^ ]+", text)
    for i, piece in enumerate(pieces):
        if piece[0] == " ":
            if len(piece) == 1 and split and column > _WIDTH and 0 < i < len(pieces) - 1:
                out.append("\n" + " " * _INDENT)
                column = _INDENT
                continue
        elif quoted:
            piece = piece.replace("'", "''")
        out.append(piece)
        column += len(piece)
    if quoted:
        out.append("'")
    return "".join(out)


def dump_flat_yaml(mapping: Dict[str, Any]) -> str:
    """``yaml.safe_dump(mapping, sort_keys=True)`` for a flat mapping."""
    if not mapping:
        return "{}\n"
    lines = []
    for key in sorted(mapping):
        if not isinstance(key, str) or not 0 < len(key) < _SIMPLE_KEY:
            raise ValueError(f"flat YAML: key {key!r} is not a string of 1 to "
                             f"{_SIMPLE_KEY - 1} characters")
        k_text, k_quoted = _scalar(key, key)
        k_out = _emit(k_text, k_quoted, 0, split=False)[1:]  # a key starts the line
        line = k_out + ":"
        v_text, v_quoted = _scalar(mapping[key], key)
        lines.append(line + _emit(v_text, v_quoted, len(line), split=True))
    return "\n".join(lines) + "\n"


def _construct(text: str, where: str) -> Any:
    """A plain scalar as ``yaml.safe_load`` constructs it."""
    tag = _resolve(text)
    if tag == "str":
        return text
    if tag == "null":
        return None
    if tag == "bool":
        return _BOOLS[text.lower()]
    if tag in ("int", "float"):
        v = text.replace("_", "")
        v = v.lower() if tag == "float" else v
        sign = -1 if v[0] == "-" else 1
        v = v[1:] if v[0] in "+-" else v
        if tag == "float" and v in (".inf", ".nan"):
            return sign * math.inf if v == ".inf" else math.nan
        if ":" in v:
            total = 0
            for part in v.split(":"):
                total = total * 60 + (float(part) if tag == "float" else int(part))
            return sign * total
        if tag == "float":
            return sign * float(v)
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    raise ValueError(f"flat YAML: {where}: a {tag} scalar is not supported")


def load_flat_yaml(text: str) -> Optional[Dict[str, Any]]:
    """``yaml.safe_load`` of a flat mapping of scalars (None for an empty
    document); comments and blank lines are dropped. Anything else raises a
    ``ValueError`` naming the line."""
    entries: List[list] = []  # [line number, key, [(line number, text), ...]]
    empty_map = None
    for n, line in enumerate(text.splitlines(), 1):
        body = line.rstrip()
        stripped = body.strip()
        if not stripped or body.startswith("#"):
            continue
        if empty_map is not None:
            raise ValueError(f"flat YAML: line {n}: text after '{{}}'")
        if body[0] in " \t":  # a continuation line (or, indented, a comment)
            if not entries:
                raise ValueError(f"flat YAML: line {n}: indented line outside a mapping")
            entries[-1][2].append((n, stripped))
            continue
        if stripped == "{}" and not entries:
            empty_map = n
            continue
        if body[0] == "'":
            key, rest = _quoted(body)
            if key is None or not re.match(r":(?:[ \t]|$)", rest):
                raise ValueError(f"flat YAML: line {n}: not a 'key: value' line: {line!r}")
            rest = rest[1:]
        else:
            m = re.search(r":(?:[ \t]|$)", body)
            key = body[: m.start()] if m else ""
            if not m or not _plain_ok(key) or _resolve(key) != "str":
                raise ValueError(f"flat YAML: line {n}: not a 'key: value' line with a "
                                 f"plain string key: {line!r}")
            rest = body[m.start() + 1 :]
        entries.append([n, key, [(n, rest.strip())] if rest.strip() else []])
    if empty_map is not None:
        return {}
    if not entries:
        return None
    out: Dict[str, Any] = {}
    for n, key, parts in entries:
        if key in out:
            raise ValueError(f"flat YAML: line {n}: key {key!r} repeated")
        out[key] = _value(parts, f"line {n}")
    return out


def _quoted(text: str) -> tuple:
    """A single-quoted scalar at the start of ``text``: (value, rest after
    the closing quote), or (None, text) if the closing quote is not there."""
    out, i = [], 1
    while i < len(text):
        if text[i] == "'":
            if text[i + 1 : i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1 :]
        out.append(text[i])
        i += 1
    return None, text


def _uncomment(text: str) -> tuple:
    """``text`` without a trailing `` # comment``, and whether it had one."""
    m = re.search(r"(?:^|[ \t])#", text)
    return (text[: m.start()].rstrip(), True) if m else (text, False)


def _value(parts: List[tuple], where: str) -> Any:
    """The value of one entry from its lines (the rest of the ``key:`` line,
    then its continuation lines), folded as YAML folds a multi-line scalar:
    a line break between two lines reads as one space."""
    if not parts:
        return None
    joined = " ".join(t for _, t in parts)
    if joined[0] == "'":
        value, rest = _quoted(joined)
        if value is None:
            raise ValueError(f"flat YAML: {where}: no closing quote")
        rest, _ = _uncomment(rest)
        if rest.strip():
            raise ValueError(f"flat YAML: {where}: text after the closing quote: {rest!r}")
        return value
    lines = []
    for i, (_, t) in enumerate(parts):
        t, comment = _uncomment(t)
        if t:
            lines.append(t)
        if comment and i < len(parts) - 1:
            raise ValueError(f"flat YAML: {where}: a comment inside a multi-line scalar")
    if not lines:
        return None
    first = lines[0]
    if first[0] in "\"[]{}&*!|>%@`,#" or (first[0] in "-?:" and first[1:2] in ("", " ")):
        raise ValueError(f"flat YAML: {where}: {first!r}: double quotes, flow style, anchors, "
                         "aliases, tags, block scalars and sequences are not supported")
    text = " ".join(lines)
    if re.search(r":(?:[ \t]|$)", text):
        raise ValueError(f"flat YAML: {where}: a nested mapping is not supported")
    return _construct(text, where)


def load_hparams(config_path: Optional[str] = None) -> Dict[str, Any]:
    """defaults → optional flat-YAML overlay with casting (ref :84-109)."""
    hp = dict(DEFAULT_HPARAMS)
    if config_path:
        if os.path.isfile(config_path):
            with open(config_path) as f:
                overlay = load_flat_yaml(f.read()) or {}
            for k, v in overlay.items():
                k = _ALIASES.get(k, k)
                hp[k] = _cast(k, v)
        else:
            logger.warning("config %s not found; using defaults", config_path)
    return hp


def add_hparam_flags(parser: argparse.ArgumentParser) -> None:
    """One CLI flag per hyperparameter (ref :163-182)."""
    parser.add_argument("--config", type=str, default=None,
                        help="flat YAML overlay (e.g. best_params.yaml)")
    for key, default in DEFAULT_HPARAMS.items():
        flag = "--" + key.replace("_", "-")
        if isinstance(default, bool):
            parser.add_argument(flag, type=str, default=None, help=f"bool, default {default}")
        else:
            parser.add_argument(flag, type=type(default), default=None,
                                help=f"default {default}")


def resolve_hparams(args) -> Dict[str, Any]:
    """defaults → YAML → non-None CLI flags (highest precedence)."""
    hp = load_hparams(getattr(args, "config", None))
    for key in DEFAULT_HPARAMS:
        val = getattr(args, key, None)
        if val is not None:
            hp[key] = _cast(key, val)
    return hp


def save_effective_hparams(hp: Dict[str, Any], output_dir: str) -> str:
    """Persist the resolved config (ref :188-191, ``effective_hparams.yaml``),
    the bytes the JAX package writes."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, "effective_hparams.yaml")
    with open(path, "w") as f:
        f.write(dump_flat_yaml(hp))
    logger.info("wrote %s", path)
    return path
