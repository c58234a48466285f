"""CTC forced alignment: emissions → trellis → backtrack → merged
segments → an utterance's (start_sec, end_sec).

Port of ``mme_tpu/data/alignment.py``. The trellis is JAX's ``lax.scan``
recursion as a loop over time with the token axis vectorised, in fp32 on
the emission's device (the card unless the caller passes
``device="cpu"``); the backtrack is sequential and stays on the host, as
in JAX. Any CTC character model can give the emissions (log-probabilities
[T, C], blank first).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mme_tpu_torch.device import DeviceLike, resolve_device

NEG_INF = -1e30

_ONES = "zero one two three four five six seven eight nine".split()
_TEENS = ("ten eleven twelve thirteen fourteen fifteen sixteen seventeen "
          "eighteen nineteen").split()
_TENS = ("twenty thirty forty fifty sixty seventy eighty ninety").split()


def _num_to_words(n: int) -> str:
    """Number words for 0..999 999 (what ``num2words`` gives the
    reference's transcripts in that range)."""
    if n < 10:
        return _ONES[n]
    if n < 20:
        return _TEENS[n - 10]
    if n < 100:
        t, r = divmod(n, 10)
        return _TENS[t - 2] + (f" {_ONES[r]}" if r else "")
    if n < 1000:
        h, r = divmod(n, 100)
        return f"{_ONES[h]} hundred" + (f" {_num_to_words(r)}" if r else "")
    th, r = divmod(n, 1000)
    return f"{_num_to_words(th)} thousand" + (f" {_num_to_words(r)}" if r else "")


def normalize_transcript(text: str) -> str:
    """Lowercase, digits to words, punctuation stripped: the CTC label
    mapping's preprocessing."""
    text = text.lower()
    text = re.sub(r"\d+", lambda m: _num_to_words(int(m.group())), text)
    text = re.sub(r"[^a-z' ]+", " ", text)
    return re.sub(r"\s+", " ", text).strip()


def ctc_trellis(emission: torch.Tensor, tokens: torch.Tensor,
                blank_id: int = 0) -> torch.Tensor:
    """Trellis [T+1, N+1] of the max-score alignment, in fp32 on the
    emission's device: row t+1 is ``[0, max(row_t[1:] + em_t[blank],
    row_t[:-1] + em_t[tokens])]``."""
    emission = emission.to(torch.float32)
    tokens = tokens.to(device=emission.device, dtype=torch.long)
    T, N = emission.shape[0], tokens.shape[0]
    rows = torch.empty((T + 1, N + 1), dtype=torch.float32,
                       device=emission.device)
    rows[:, 0] = 0.0
    rows[0, 1:] = NEG_INF
    blank = emission[:, blank_id]
    change_em = emission[:, tokens]               # [T, N]
    for t in range(T):
        prev = rows[t]
        torch.maximum(prev[1:] + blank[t], prev[:-1] + change_em[t],
                      out=rows[t + 1, 1:])
    return rows


@dataclasses.dataclass
class PathPoint:
    token_index: int
    time_index: int
    score: float


def backtrack(trellis: np.ndarray, emission: np.ndarray,
              tokens: Sequence[int], blank_id: int = 0
              ) -> Optional[List[PathPoint]]:
    """The best path through the trellis, on the host; None when the
    alignment fails."""
    trellis = np.asarray(trellis)
    emission = np.asarray(emission)
    j = trellis.shape[1] - 1
    t_start = int(np.argmax(trellis[:, j]))
    path: List[PathPoint] = []
    for t in range(t_start, 0, -1):
        stayed = trellis[t - 1, j] + emission[t - 1, blank_id]
        changed = trellis[t - 1, j - 1] + emission[t - 1, tokens[j - 1]]
        prob = float(np.exp(
            emission[t - 1, tokens[j - 1] if changed > stayed else blank_id]))
        path.append(PathPoint(j - 1, t - 1, prob))
        if changed > stayed:
            j -= 1
            if j == 0:
                break
    else:
        return None
    return path[::-1]


@dataclasses.dataclass
class Segment:
    label: str
    start: int
    end: int
    score: float


def merge_repeats(path: List[PathPoint], transcript: str) -> List[Segment]:
    segments = []
    i1 = 0
    while i1 < len(path):
        i2 = i1
        while i2 < len(path) and path[i1].token_index == path[i2].token_index:
            i2 += 1
        score = sum(p.score for p in path[i1:i2]) / (i2 - i1)
        segments.append(Segment(transcript[path[i1].token_index],
                                path[i1].time_index,
                                path[i2 - 1].time_index + 1, score))
        i1 = i2
    return segments


def utterance_bounds(emission: np.ndarray, transcript: str,
                     char2id: Dict[str, int], num_samples: int,
                     sample_rate: int = 16000, blank_id: int = 0,
                     device: DeviceLike = "cuda"
                     ) -> Optional[Tuple[float, float]]:
    """The whole pipeline → (start_sec, end_sec) of the spoken transcript,
    or None when nothing aligns. The trellis runs on ``device``."""
    transcript = normalize_transcript(transcript).replace(" ", "|")
    tokens = [char2id[c] for c in transcript if c in char2id]
    if not tokens:
        return None
    dev = resolve_device(device)
    em = torch.as_tensor(np.asarray(emission, np.float32), device=dev)
    trellis = ctc_trellis(em, torch.as_tensor(tokens), blank_id).cpu().numpy()
    path = backtrack(trellis, emission, tokens, blank_id)
    if path is None:
        return None
    segments = merge_repeats(path, transcript)
    ratio = num_samples / emission.shape[0]
    return (segments[0].start * ratio / sample_rate,
            segments[-1].end * ratio / sample_rate)
