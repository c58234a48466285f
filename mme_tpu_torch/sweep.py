"""Hyperparameter sweeps: the reference's wandb-sweep YAML contract, run
locally.

Port of ``mme_tpu/core/sweep.py`` (numpy only). The YAML files
(``configs/*.yaml``: ``method`` bayes/random/grid, ``metric {name,
goal}``, ``parameters`` with ``values`` lists, a ``value``, or
``distribution: uniform/log_uniform/int_uniform {min, max}``) are parsed
and their trials driven in-process: grid and random exactly, ``bayes`` as
a dependency-free TPE (Tree-structured Parzen Estimator) that turns
adaptive after ``TPE_STARTUP`` observations. Every draw comes from
``np.random.RandomState((seed * 1000003 + i) & 0x7FFFFFFF)`` for the global
trial index ``i``, as in JAX, so trial sequences and TPE proposals equal
JAX's value for value, and ``trial_offset`` / ``stride`` partitions of
the global sequence tile the single-process one.

The YAML is read by :func:`load_yaml`, this module's own reader (the
machine with the card has no PyYAML). It reads the subset the sweep
configs use, and resolves plain scalars as YAML 1.1's ``safe_load``
does; anything outside the subset raises :class:`YamlError`.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import re
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np


# ------------------------------------------------------------ YAML subset

class YamlError(ValueError):
    """YAML outside the reader's subset, or malformed."""


# the implicit resolvers of PyYAML's SafeLoader (YAML 1.1), by first char
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_TRUE = ("yes", "true", "on")


def _sexagesimal(digits: str, base_cast) -> Any:
    value = 0
    for part in digits.split(":"):
        value = value * 60 + base_cast(part)
    return value


def _plain_scalar(text: str) -> Any:
    """A plain scalar resolved as ``yaml.safe_load`` resolves it."""
    if text[:1] in "yYnNtTfFoO" and _BOOL.match(text):
        return text.lower() in _TRUE
    if text[:1] in "-+0123456789." and _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v.startswith("-") else 1.0
        if v[:1] in "+-":
            v = v[1:]
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        if ":" in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    if text[:1] in "-+0123456789" and _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v.startswith("-") else 1
        if v[:1] in "+-":
            v = v[1:]
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v.startswith("0"):
            return sign * int(v, 8)
        if ":" in v:
            return sign * _sexagesimal(v, int)
        return sign * int(v)
    if _NULL.match(text):
        return None
    if _TIMESTAMP.match(text):
        raise YamlError(f"timestamp scalar {text!r} is outside the subset")
    if text[:1] in "&*!|>%@`" or text in ("=", "<<"):
        raise YamlError(f"{text!r}: anchors, aliases, tags, block scalars "
                        "and directives are outside the subset")
    return text


def _quoted(text: str, i: int) -> Tuple[str, int]:
    """The quoted scalar starting at ``text[i]``; returns (value, index
    after the closing quote)."""
    q = text[i]
    out = []
    j = i + 1
    while j < len(text):
        c = text[j]
        if q == "'" and c == "'":
            if text[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            nxt = text[j + 1:j + 2]
            escapes = {"n": "\n", "t": "\t", "\\": "\\", '"': '"',
                       "/": "/", "0": "\0", "r": "\r", " ": " "}
            if nxt in escapes:
                out.append(escapes[nxt])
                j += 2
                continue
            if nxt in ("x", "u", "U"):
                width = {"x": 2, "u": 4, "U": 8}[nxt]
                out.append(chr(int(text[j + 2:j + 2 + width], 16)))
                j += 2 + width
                continue
            raise YamlError(f"unsupported escape \\{nxt} in {text!r}")
        if q == '"' and c == '"':
            return "".join(out), j + 1
        out.append(c)
        j += 1
    raise YamlError(f"unterminated quoted scalar in {text!r}")


class _Flow:
    """A recursive reader of one flow node: ``[a, b]``, ``{k: v}``, a quoted
    or plain scalar (inside a collection a plain scalar ends at ``,``,
    ``]``, ``}`` or ``": "``)."""

    def __init__(self, text: str):
        self.text = text
        self.i = 0

    def _skip(self) -> None:
        while self.i < len(self.text) and self.text[self.i] in " \t\n":
            self.i += 1

    def node(self, nested: bool) -> Any:
        self._skip()
        c = self.text[self.i:self.i + 1]
        if c == "[":
            return self._seq()
        if c == "{":
            return self._map()
        if c in ("'", '"'):
            value, self.i = _quoted(self.text, self.i)
            return value
        return self._plain(nested)

    def _plain(self, nested: bool) -> Any:
        start = self.i
        while self.i < len(self.text):
            c = self.text[self.i]
            if nested and c in ",]}":
                break
            if nested and c == ":" and self.text[self.i + 1:self.i + 2] in (
                    " ", "\n", ",", "]", "}", ""):
                break
            self.i += 1
        return _plain_scalar(self.text[start:self.i].strip())

    def _seq(self) -> List[Any]:
        self.i += 1
        out: List[Any] = []
        while True:
            self._skip()
            if self.text[self.i:self.i + 1] == "]":
                self.i += 1
                return out
            out.append(self.node(nested=True))
            self._skip()
            c = self.text[self.i:self.i + 1]
            if c == ",":
                self.i += 1
            elif c != "]":
                raise YamlError(f"expected ',' or ']' in {self.text!r}")

    def _map(self) -> Dict[Any, Any]:
        self.i += 1
        out: Dict[Any, Any] = {}
        while True:
            self._skip()
            if self.text[self.i:self.i + 1] == "}":
                self.i += 1
                return out
            key = self.node(nested=True)
            self._skip()
            if self.text[self.i:self.i + 1] != ":":
                raise YamlError(f"expected ':' after a key in {self.text!r}")
            self.i += 1
            self._skip()
            if self.text[self.i:self.i + 1] in (",", "}"):
                value = None
            else:
                value = self.node(nested=True)
            out[key] = value
            self._skip()
            c = self.text[self.i:self.i + 1]
            if c == ",":
                self.i += 1
            elif c != "}":
                raise YamlError(f"expected ',' or '}}' in {self.text!r}")


def _flow(text: str) -> Any:
    reader = _Flow(text)
    value = reader.node(nested=False)
    reader._skip()
    if reader.i != len(text):
        raise YamlError(f"trailing text after a flow node: {text!r}")
    return value


def _strip_comment(line: str) -> str:
    """The line without its comment (``#`` at the start or after
    whitespace, outside quotes)."""
    quote = None
    i = 0
    while i < len(line):
        c = line[i]
        if quote:
            if quote == "'" and line[i:i + 2] == "''":
                i += 1                  # an escaped quote
            elif quote == '"' and c == "\\":
                i += 1                  # an escaped character
            elif c == quote:
                quote = None
        elif c in ("'", '"') and (i == 0 or line[i - 1] in " \t:[{,"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _key_split(body: str) -> Optional[Tuple[Any, str]]:
    """``key: rest`` → (key, rest); None for a line that is no mapping
    entry."""
    if body[:1] in ("'", '"'):
        key, j = _quoted(body, 0)
        rest = body[j:]
        if not rest.startswith(":"):
            return None
        return key, rest[1:].strip()
    m = re.match(r"^([^:#\[\]{},]+?)\s*:(?:\s+|$)(.*)$", body)
    if m is None:
        return None
    return _plain_scalar(m.group(1).strip()), m.group(2).strip()


def _depth(text: str) -> int:
    depth, quote = 0, None
    for c in text:
        if quote:
            quote = None if c == quote else quote
        elif c in ("'", '"'):
            quote = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
    return depth


def load_yaml(text: str) -> Any:
    """Parse YAML text of the sweep configs' subset: block mappings by
    indentation, flow lists and mappings (nested, possibly over several
    lines), comments, single- and double-quoted strings, and plain
    scalars resolved as ``yaml.safe_load`` resolves them (YAML 1.1:
    ``True``/``no`` are booleans, ``1.0e-5`` and ``.25`` floats, ``5e-6``
    the string ``'5e-6'``, ``~`` None). Block sequences, anchors,
    aliases, tags, block scalars, directives and multiple documents raise
    :class:`YamlError`."""
    lines: List[Tuple[int, str]] = []
    for raw in text.splitlines():
        if raw.startswith(("---", "...", "%")):
            raise YamlError(f"document markers and directives are outside "
                            f"the subset: {raw!r}")
        line = _strip_comment(raw)
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        if line[indent:indent + 1] == "\t":
            raise YamlError(f"a tab in the indentation: {raw!r}")
        lines.append((indent, line[indent:]))
    if not lines:
        return None
    pos = [0]

    def take_flow(first: str) -> str:
        """A flow node that may continue on the next lines."""
        parts = [first]
        while _depth(" ".join(parts)) > 0:
            if pos[0] >= len(lines):
                raise YamlError(f"unterminated flow collection: {first!r}")
            parts.append(lines[pos[0]][1])
            pos[0] += 1
        return " ".join(parts)

    def value_of(rest: str, indent: int) -> Any:
        if rest:
            if rest[:1] in "[{":
                return _flow(take_flow(rest))
            if rest[:1] in ("'", '"'):
                value, j = _quoted(rest, 0)
                if rest[j:].strip():
                    raise YamlError(f"text after a quoted scalar: {rest!r}")
                return value
            if rest[:1] in "|>":
                raise YamlError(f"block scalars are outside the subset: "
                                f"{rest!r}")
            return _plain_scalar(rest)
        if pos[0] < len(lines) and lines[pos[0]][0] > indent:
            return block(lines[pos[0]][0])
        return None

    def block(indent: int) -> Any:
        first = lines[pos[0]][1]
        if first.startswith("- ") or first == "-":
            raise YamlError(f"block sequences are outside the subset: "
                            f"{first!r}")
        if _key_split(first) is None:
            pos[0] += 1
            if first[:1] in "[{":
                return _flow(take_flow(first))
            return value_of(first, indent)
        out: Dict[Any, Any] = {}
        while pos[0] < len(lines):
            ind, body = lines[pos[0]]
            if ind < indent:
                break
            if ind > indent:
                raise YamlError(f"unexpected indentation: {body!r}")
            kv = _key_split(body)
            if kv is None:
                raise YamlError(f"expected 'key: value', got {body!r}")
            pos[0] += 1
            key, rest = kv
            out[key] = value_of(rest, indent)
        return out

    value = block(lines[0][0])
    if pos[0] != len(lines):
        raise YamlError(f"unexpected text: {lines[pos[0]][1]!r}")
    return value


# ---------------------------------------------------------------- sweeps

@dataclasses.dataclass
class SweepConfig:
    method: str
    metric_name: str
    metric_goal: str
    parameters: Dict[str, Dict[str, Any]]
    program: Optional[str] = None

    @staticmethod
    def from_yaml(path_or_str: str) -> "SweepConfig":
        """A config from a YAML file's path or from YAML text (JAX's
        test of which one it is)."""
        if "\n" in path_or_str or ":" not in path_or_str.split("\n")[0][:40]:
            try:
                with open(path_or_str) as f:
                    raw = load_yaml(f.read())
            except (OSError, ValueError):
                raw = load_yaml(path_or_str)
        else:
            raw = load_yaml(path_or_str)
        metric = raw.get("metric", {})
        return SweepConfig(
            method=raw.get("method", "random"),
            metric_name=metric.get("name", "val/loss"),
            metric_goal=metric.get("goal", "minimize"),
            parameters=raw.get("parameters", {}),
            program=raw.get("program"))


def _sample_param(rng: np.random.RandomState, spec: Dict[str, Any]) -> Any:
    if "values" in spec:
        vals = spec["values"]
        return vals[rng.randint(len(vals))]
    if "value" in spec:
        return spec["value"]
    dist = spec.get("distribution", "uniform")
    lo, hi = float(spec["min"]), float(spec["max"])
    if dist in ("uniform",):
        return float(rng.uniform(lo, hi))
    if dist in ("log_uniform", "log_uniform_values"):
        return float(min(max(np.exp(rng.uniform(np.log(lo), np.log(hi))),
                             lo), hi))
    if dist in ("int_uniform",):
        return int(rng.randint(int(lo), int(hi) + 1))
    raise ValueError(f"unsupported distribution {dist}")


def _trial_rng(seed: int, i: int) -> np.random.RandomState:
    return np.random.RandomState((seed * 1000003 + i) & 0x7FFFFFFF)


def iter_trials(cfg: SweepConfig, num_trials: int, seed: int = 0,
                trial_offset: int = 0, stride: int = 1
                ) -> Iterator[Dict[str, Any]]:
    """Trials ``trial_offset, trial_offset+stride, ...`` (``num_trials`` of
    them) of the global sequence defined by ``seed``; a random trial is
    keyed on its index, so disjoint (offset, stride) partitions tile the
    single-process sequence."""
    if cfg.method == "grid":
        keys = list(cfg.parameters)
        grids = []
        for k in keys:
            spec = cfg.parameters[k]
            grids.append(spec["values"] if "values" in spec
                         else [spec["value"]])
        combos = itertools.islice(itertools.product(*grids), trial_offset,
                                  None, stride)
        for combo in itertools.islice(combos, num_trials):
            yield dict(zip(keys, combo))
    else:  # random, and bayes read as random
        for k_i in range(num_trials):
            rng = _trial_rng(seed, trial_offset + k_i * stride)
            yield {k: _sample_param(rng, spec)
                   for k, spec in cfg.parameters.items()}


@dataclasses.dataclass
class TrialResult:
    params: Dict[str, Any]
    metrics: Dict[str, float]


# ---------------------------------------------------------------- TPE bayes

TPE_STARTUP = 5      # random trials before the model kicks in
TPE_GAMMA = 0.25     # fraction of observations labeled "good"
TPE_CANDIDATES = 24  # proposals scored per continuous parameter


def _transform(spec: Dict[str, Any]):
    """(to_internal, from_internal, lo, hi) for a continuous spec."""
    dist = spec.get("distribution", "uniform")
    lo, hi = float(spec["min"]), float(spec["max"])
    if dist in ("log_uniform", "log_uniform_values"):
        return np.log, np.exp, np.log(lo), np.log(hi)
    return (lambda x: x), (lambda x: x), lo, hi


def _kde_logdensity(x: np.ndarray, obs: np.ndarray, lo: float, hi: float
                    ) -> np.ndarray:
    """Gaussian KDE with a range-scaled bandwidth + uniform prior mass."""
    sigma = max((hi - lo) * 0.05, (hi - lo) / max(np.sqrt(len(obs)), 1.0))
    d = (x[:, None] - obs[None, :]) / sigma
    kernel = np.exp(-0.5 * d * d).mean(axis=1) / sigma
    prior = 1.0 / max(hi - lo, 1e-12)
    return np.log(0.5 * kernel + 0.5 * prior + 1e-300)


def _split_good_bad(history: List[TrialResult], metric: str,
                    minimize: bool):
    scored = [(r.metrics.get(metric), r.params) for r in history
              if r.metrics.get(metric) is not None
              and np.isfinite(r.metrics.get(metric))]
    scored.sort(key=lambda t: t[0], reverse=not minimize)
    n_good = max(1, int(np.ceil(TPE_GAMMA * len(scored))))
    return ([p for _, p in scored[:n_good]],
            [p for _, p in scored[n_good:]])


def _tpe_param(rng: np.random.RandomState, key: str, spec: Dict[str, Any],
               good: List[Dict[str, Any]], bad: List[Dict[str, Any]]) -> Any:
    if "value" in spec:
        return spec["value"]
    if "values" in spec:
        vals = spec["values"]
        idx = {repr(v): i for i, v in enumerate(vals)}
        cg = np.ones(len(vals))
        cb = np.ones(len(vals))
        for p in good:
            if repr(p.get(key)) in idx:
                cg[idx[repr(p.get(key))]] += 1
        for p in bad:
            if repr(p.get(key)) in idx:
                cb[idx[repr(p.get(key))]] += 1
        ratio = (cg / cg.sum()) / (cb / cb.sum())
        probs = ratio / ratio.sum()
        return vals[rng.choice(len(vals), p=probs)]
    to_i, from_i, lo, hi = _transform(spec)
    g_obs = np.asarray([to_i(float(p[key])) for p in good if key in p])
    b_obs = np.asarray([to_i(float(p[key])) for p in bad if key in p])
    if len(g_obs) == 0:
        cand = rng.uniform(lo, hi, TPE_CANDIDATES)
    else:
        centers = g_obs[rng.randint(len(g_obs), size=TPE_CANDIDATES)]
        sigma = max((hi - lo) * 0.05,
                    (hi - lo) / max(np.sqrt(len(g_obs)), 1.0))
        cand = np.clip(centers + rng.randn(TPE_CANDIDATES) * sigma, lo, hi)
    score = _kde_logdensity(cand, g_obs, lo, hi) if len(g_obs) else \
        np.zeros(len(cand))
    if len(b_obs):
        score = score - _kde_logdensity(cand, b_obs, lo, hi)
    x = float(from_i(cand[int(np.argmax(score))]))
    if spec.get("distribution") == "int_uniform":
        return int(np.clip(round(x), int(spec["min"]), int(spec["max"])))
    # exp(log(hi)) can overshoot hi by an ulp: clamp in the original space
    return float(min(max(x, float(spec["min"])), float(spec["max"])))


def tpe_propose(cfg: SweepConfig, history: List[TrialResult],
                rng: np.random.RandomState) -> Dict[str, Any]:
    """Propose one trial from the observed history (TPE with independent
    densities per parameter, the wandb / hyperopt factorisation)."""
    minimize = cfg.metric_goal == "minimize"
    good, bad = _split_good_bad(history, cfg.metric_name, minimize)
    return {k: _tpe_param(rng, k, spec, good, bad)
            for k, spec in cfg.parameters.items()}


def best_of(results: List[TrialResult], metric_name: str,
            metric_goal: str) -> TrialResult:
    sign = -1.0 if metric_goal == "minimize" else 1.0
    return max(results,
               key=lambda r: sign * r.metrics.get(metric_name,
                                                  float("-inf") * sign))


def run_sweep(cfg: SweepConfig, trial_fn: Callable[[Dict[str, Any]],
                                                   Dict[str, float]],
              num_trials: int, seed: int = 0,
              log: Callable[[str], None] = print,
              trial_offset: int = 0, stride: int = 1,
              observations: Optional[List[TrialResult]] = None,
              refresh_observations: Optional[
                  Callable[[], List[TrialResult]]] = None
              ) -> TrialResult:
    """Run trials, return the best by the sweep metric.

    ``method: bayes`` turns adaptive after ``TPE_STARTUP`` observations:
    each next trial is proposed by :func:`tpe_propose` conditioned on this
    agent's history, any pre-seeded ``observations`` and, polled before
    every proposal, ``refresh_observations()`` (parallel agents pass a
    reader of their siblings' results). grid and random keep the
    index-keyed sequence."""
    best: Optional[TrialResult] = None
    sign = -1.0 if cfg.metric_goal == "minimize" else 1.0
    history: List[TrialResult] = list(observations or [])
    bayes = cfg.method == "bayes"

    def known():
        external = refresh_observations() if refresh_observations else []
        return external + history

    def trial_params():
        if not bayes:
            yield from iter_trials(cfg, num_trials, seed, trial_offset,
                                   stride)
            return
        for k_i in range(num_trials):
            rng = _trial_rng(seed, trial_offset + k_i * stride)
            obs = known()
            if len(obs) >= TPE_STARTUP:
                yield tpe_propose(cfg, obs, rng)
            else:
                # startup: the random sequence, so parallel partitions stay
                # deterministic
                yield {k: _sample_param(rng, spec)
                       for k, spec in cfg.parameters.items()}

    for i, params in enumerate(trial_params()):
        metrics = trial_fn(params)
        r = TrialResult(params, metrics)
        history.append(r)
        score = sign * metrics.get(cfg.metric_name, float("-inf") * sign)
        best_score = (sign * best.metrics.get(cfg.metric_name, float("nan"))
                      if best else float("-inf"))
        if best is None or score > best_score:
            best = r
        log(json.dumps({"trial": i, "params": params,
                        cfg.metric_name: metrics.get(cfg.metric_name)}))
    assert best is not None
    return best
