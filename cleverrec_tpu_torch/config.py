"""Typed two-level configuration.

The reference merges a global INI ``[default]`` section with a per-model
``[parameters]`` section into one flat string dict and casts at every use
site (reference: main.py:18-25, model/Recommender.py:16-28).  We keep the
same two-level merge semantics (later keys win) but add what the reference
lacks: typed accessors, validation at load time, and an alias table that
papers over the reference's config/code drift (e.g. ``conf/GMF.properties``
defines ``reg_gmf`` while the model code reads ``reg``; ``init_method =
xavier_uniform`` is unhandled by the reference's initializer factory —
SURVEY.md section 2.5 item 4).
"""

from __future__ import annotations

import configparser
import os
from typing import Any, Iterable, Mapping

# Per-model key aliases: {model: {ini_key: canonical_key}}.  These repair the
# reference's config drift so its shipped .properties files work unmodified.
_MODEL_KEY_ALIASES: dict[str, dict[str, str]] = {
    "GMF": {"reg_gmf": "reg"},
    "MLP": {"reg_mlp": "reg"},
    "NeuMF": {"reg_gmf": "reg1", "reg_mlp": "reg2"},
}

# init_method aliases (reference factory: utils/tools.py:51-63 silently
# returns None for unknown names; we accept the common synonyms instead).
_INIT_ALIASES = {
    "xavier_uniform": "xavier",
    "glorot_uniform": "xavier",
    "glorot_normal": "xavier_normal",
    "he_uniform": "he",
    "truncated_normal": "tnormal",
}

_VALID_INITS = {"normal", "tnormal", "uniform", "xavier", "xavier_normal", "he"}
_VALID_OPTIMIZERS = {"SGD", "Adam", "Adagrad"}
_VALID_LOSSES = {"cross_entropy", "bpr", "hinge", "square"}
_VALID_FORMATS = {"UI", "UIR", "UIRT"}
_VALID_SPLITS = {"rs", "loo"}


def _parse_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("true", "1", "yes")


def _parse_list(v: Any, cast=float) -> list:
    """Parse the reference's ``[a,b,c]`` list syntax (Recommender.py:27)."""
    if isinstance(v, (list, tuple)):
        return [cast(x) for x in v]
    s = str(v).strip()
    if s.startswith("[") and s.endswith("]"):
        s = s[1:-1]
    return [cast(x.strip()) for x in s.split(",") if x.strip()]


class Config:
    """Flat merged config with typed accessors.

    Build from INI files (``Config.from_properties``) or directly from a
    dict (tests / programmatic use).  Unknown keys are kept — model classes
    validate their own requirements via ``require``.
    """

    def __init__(self, values: Mapping[str, Any]):
        self._v: dict[str, Any] = dict(values)
        model = self._v.get("recommender", "")
        for src, dst in _MODEL_KEY_ALIASES.get(model, {}).items():
            if src in self._v and dst not in self._v:
                self._v[dst] = self._v[src]
        self._validate()

    # -- construction -----------------------------------------------------
    @classmethod
    def from_properties(cls, global_path: str, conf_dir: str | None = None,
                        overrides: Mapping[str, Any] | None = None) -> "Config":
        """Two-level merge: global ``[default]`` then per-model ``[parameters]``.

        Mirrors the reference entry point's merge order (main.py:18-25):
        per-model keys win over global keys; explicit ``overrides`` win over
        both (the reference has no override mechanism; we add one for CLI
        ``--set key=value``).
        """
        cp = configparser.ConfigParser()
        cp.optionxform = str  # keep case
        with open(global_path, encoding="utf-8") as f:
            cp.read_file(f)
        values = dict(cp.items("default"))
        model = (overrides or {}).get("recommender", values.get("recommender"))
        if model:
            values["recommender"] = model
            # --set config_dir=... must steer the model-file lookup too.
            conf_dir = (conf_dir
                        or (overrides or {}).get("config_dir")
                        or values.get("config_dir", "./conf"))
            model_path = os.path.join(conf_dir, f"{model}.properties")
            if os.path.exists(model_path):
                mp = configparser.ConfigParser()
                mp.optionxform = str
                with open(model_path, encoding="utf-8") as f:
                    mp.read_file(f)
                values.update(dict(mp.items("parameters")))
        if overrides:
            values.update(overrides)
        return cls(values)

    # -- validation -------------------------------------------------------
    @staticmethod
    def _dequote(v: Any) -> str:
        """INI-style quote stripping, matching Config.str (the reference
        ships quoted values like atten_type='prod')."""
        s = str(v).strip()
        if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
            s = s[1:-1]
        return s

    def _validate(self) -> None:
        v = self._v
        if "init_method" in v:
            m = self._dequote(v["init_method"])
            m = _INIT_ALIASES.get(m, m)
            if m not in _VALID_INITS:
                raise ValueError(f"unknown init_method {v['init_method']!r}")
            v["init_method"] = m
        for key, valid in (("optimizer", _VALID_OPTIMIZERS),
                           ("loss_func", _VALID_LOSSES),
                           ("data.format", _VALID_FORMATS),
                           ("data.split_way", _VALID_SPLITS)):
            if key in v and self._dequote(v[key]) not in valid:
                raise ValueError(f"unknown {key} {v[key]!r}")

    # -- generic accessors ------------------------------------------------
    def __contains__(self, key: str) -> bool:
        return key in self._v

    def get(self, key: str, default: Any = None) -> Any:
        return self._v.get(key, default)

    def require(self, *keys: str) -> None:
        missing = [k for k in keys if k not in self._v]
        if missing:
            model = self._v.get("recommender", "?")
            raise KeyError(f"model {model}: missing config keys {missing}")

    def int(self, key: str, default: int | None = None) -> int:
        v = self._v.get(key, default)
        if v is None:
            raise KeyError(key)
        return int(v)

    def float(self, key: str, default: float | None = None) -> float:
        v = self._v.get(key, default)
        if v is None:
            raise KeyError(key)
        return float(v)

    def str(self, key: str, default: str | None = None) -> str:
        v = self._v.get(key, default)
        if v is None:
            raise KeyError(key)
        # Strip INI-style quotes (the reference ships atten_type='prod')
        # but NOT whitespace — a literal tab separator must survive.
        s = str(v)
        if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
            s = s[1:-1]
        return s

    def bool(self, key: str, default: bool = False) -> bool:
        return _parse_bool(self._v.get(key, default))

    def int_list(self, key: str, default: Iterable[int] | None = None) -> list[int]:
        v = self._v.get(key, default)
        if v is None:
            raise KeyError(key)
        return _parse_list(v, int)

    def float_list(self, key: str, default: Iterable[float] | None = None) -> list[float]:
        v = self._v.get(key, default)
        if v is None:
            raise KeyError(key)
        return _parse_list(v, float)

    def to_dict(self) -> dict[str, Any]:
        return dict(self._v)

    def with_overrides(self, **kw: Any) -> "Config":
        d = dict(self._v)
        d.update(kw)
        # Overriding an alias SOURCE (e.g. reg_gmf for GMF) must win over
        # the canonical key materialized at construction — drop the stale
        # dst so __init__ re-aliases from the fresh source value.
        aliases = _MODEL_KEY_ALIASES.get(d.get("recommender", ""), {})
        for src, dst in aliases.items():
            if src in kw and dst not in kw:
                d.pop(dst, None)
        return Config(d)

    # -- common typed fields (reference: Recommender.py:16-28) ------------
    @property
    def recommender(self) -> str:
        return self.str("recommender")

    @property
    def model_type(self) -> str:
        return self.str("model_type", "ranking")

    @property
    def epoches(self) -> int:
        return self.int("epoches")

    @property
    def batch_size(self) -> int:
        return self.int("batch_size")

    @property
    def test_batch_size(self) -> int:
        return self.int("test.batch_size", 1024)

    @property
    def lr(self) -> float:
        return self.float("lr")

    @property
    def neg_samples(self) -> int:
        """0 = score full catalog; N>0 = N sampled negative candidates."""
        return self.int("test.neg_samples", 0)

    @property
    def neg_ratio(self) -> int:
        return self.int("neg_ratio", 1)

    @property
    def is_pairwise(self) -> bool:
        return _parse_bool(self._v.get("is_pairwise", "False"))

    @property
    def fism_like(self) -> bool:
        # Presence flag in the reference (Recommender.py:19).
        return "fism_like" in self._v

    @property
    def cml_like(self) -> bool:
        # Presence flag: distance models where lower score = better.
        return "cml_like" in self._v

    @property
    def loss_func(self) -> str:
        return self.str("loss_func", "bpr")

    @property
    def optimizer(self) -> str:
        return self.str("optimizer", "Adam")

    @property
    def init_method(self) -> str:
        return self.str("init_method", "normal")

    @property
    def stddev(self) -> float:
        return self.float("stddev", 0.01)

    @property
    def test_interval(self) -> int:
        return self.int("test.interval", 1)

    @property
    def topk(self) -> list[int]:
        return self.int_list("topk", [10, 20])

    @property
    def split_way(self) -> str:
        return self.str("data.split_way", "rs")

    @property
    def candidate_eval(self) -> bool:
        """True when eval scores a per-user candidate list instead of the
        full catalog (reference predicate: split_way=='loo' or neg_samples>0,
        e.g. BPR.py:49)."""
        return self.split_way == "loo" or self.neg_samples > 0

    @property
    def seed(self) -> int:
        return self.int("seed", 2026)
