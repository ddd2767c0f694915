"""Numeric encoding of dbmarts and 64-bit sequence packing (paper §Methods).

The paper dictionary-encodes phenX strings and patient ids to dense integers,
then packs a (start_phenx, end_phenx) pair into a single 64-bit integer:

  * ``paper`` codec — decimal shift: ``seq = start * 10**7 + end``
    (the paper appends the zero-padded 7-digit end code; vocab < 10**7).
  * ``bit`` codec (default) — ``seq = (start << 24) | end``
    (vocab < 2**24; one shift and one or, and a larger id space).

Durations (days) are carried separately as int32, and can be *fused* into
the low bits of the id with a bucketed bit-shift — the paper's "cheap
bitshift operations to shift the duration on the last bits of the
sequence".

Every function takes tensors (or anything ``torch.as_tensor`` accepts) and
returns tensors on the input's device.  Ids are int64, phenX codes, days
and buckets int32.  Integer division is floor division, as in the paper's
reference implementation (``torch.div(..., rounding_mode="floor")``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

# --- codec constants -------------------------------------------------------
BIT_SHIFT = 24                      # bits for the end-phenX slot
BIT_MASK = (1 << BIT_SHIFT) - 1
PAPER_SHIFT = 10**7                 # the paper's 7-digit decimal shift
DUR_BITS = 15                       # fused-duration bucket bits (63-bit total)
DUR_MASK = (1 << DUR_BITS) - 1
MAX_BIT_VOCAB = 1 << BIT_SHIFT
MAX_PAPER_VOCAB = PAPER_SHIFT
SENTINEL = np.iinfo(np.int64).max   # the paper's UINT_MAX marking trick

CODECS = ("bit", "paper")


def _check_codec(codec: str) -> None:
    if codec not in CODECS:
        raise ValueError(f"unknown codec {codec!r}; expected one of {CODECS}")


def as_tensor(x, dtype: torch.dtype) -> torch.Tensor:
    """``x`` as a tensor of ``dtype``, on its own device (the CPU for numpy
    arrays and Python values); no copy when it already is one."""
    return torch.as_tensor(x).to(dtype)


# --- packing (int64) ---------------------------------------------------------
def pack(start, end, codec: str = "bit") -> torch.Tensor:
    """Pack (start, end) phenX ids into a single int64 sequence id."""
    _check_codec(codec)
    start = as_tensor(start, torch.int64)
    end = as_tensor(end, torch.int64)
    if codec == "bit":
        return (start << BIT_SHIFT) | end
    return start * PAPER_SHIFT + end


def unpack(seq, codec: str = "bit") -> tuple[torch.Tensor, torch.Tensor]:
    """Invert :func:`pack`; returns (start, end) as int32."""
    _check_codec(codec)
    seq = as_tensor(seq, torch.int64)
    if codec == "bit":
        return (seq >> BIT_SHIFT).to(torch.int32), (seq & BIT_MASK).to(torch.int32)
    return (torch.div(seq, PAPER_SHIFT, rounding_mode="floor").to(torch.int32),
            torch.remainder(seq, PAPER_SHIFT).to(torch.int32))


def fuse_duration(seq, dur_bucket) -> torch.Tensor:
    """Shift a bucketed duration into the low bits of the id (paper trick)."""
    seq = as_tensor(seq, torch.int64)
    b = torch.clamp(as_tensor(dur_bucket, torch.int64), 0, DUR_MASK)
    return (seq << DUR_BITS) | b


def split_duration(fused) -> tuple[torch.Tensor, torch.Tensor]:
    fused = as_tensor(fused, torch.int64)
    return fused >> DUR_BITS, (fused & DUR_MASK).to(torch.int32)


def bucket_duration(dur_days, bucket_days: int = 30) -> torch.Tensor:
    """Duration (days) -> coarse bucket id (default: ~months), floor division."""
    d = as_tensor(dur_days, torch.int32)
    q = torch.div(d, bucket_days, rounding_mode="floor")
    return torch.clamp(q, 0, DUR_MASK).to(torch.int32)


def max_vocab(codec: str = "bit") -> int:
    _check_codec(codec)
    return MAX_BIT_VOCAB if codec == "bit" else MAX_PAPER_VOCAB


# --- host-side lookup tables (paper: "requires lookup tables") -------------
@dataclasses.dataclass
class Vocab:
    """Bidirectional phenX / patient lookup tables (host-side)."""

    phenx_strings: list[str]
    patient_keys: list
    phenx_index: dict[str, int] = dataclasses.field(default_factory=dict)
    patient_index: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.phenx_index:
            self.phenx_index = {s: i for i, s in enumerate(self.phenx_strings)}
        if not self.patient_index:
            self.patient_index = {k: i for i, k in enumerate(self.patient_keys)}

    @property
    def n_phenx(self) -> int:
        return len(self.phenx_strings)

    @property
    def n_patients(self) -> int:
        return len(self.patient_keys)

    def decode_phenx(self, pid: int) -> str:
        return self.phenx_strings[int(pid)]

    def decode_sequence(self, seq_id: int, codec: str = "bit",
                        fused: bool = False) -> str:
        """Human-readable 'start -> end' (paper: reversible representation).

        ``fused`` strips a fused duration bucket first and appends it as
        ``[bucket k]`` — decoding a fused id raw would index garbage."""
        return self.decode_sequences([int(seq_id)], codec, fused)[0]

    def decode_sequences(self, seq_ids, codec: str = "bit",
                         fused: bool = False) -> list[str]:
        """:meth:`decode_sequence` of many ids, unpacked in one pass."""
        seq = as_tensor(seq_ids, torch.int64).reshape(-1).cpu()
        buckets = None
        if fused:
            seq, buckets = split_duration(seq)
        s, e = unpack(seq, codec)
        names = self.phenx_strings
        texts = [f"{names[a]} -> {names[b]}"
                 for a, b in zip(s.tolist(), e.tolist())]
        if buckets is None:
            return texts
        return [f"{t} [bucket {b}]" for t, b in zip(texts, buckets.tolist())]


def build_vocab(patients: Sequence, phenx: Sequence[str]) -> Vocab:
    """Assign running numbers starting at 0 to unique phenX / patients.

    Matches the paper: ids are assigned in first-appearance order so the
    patient id doubles as an array index.
    """
    phenx_strings: list[str] = []
    phenx_index: dict[str, int] = {}
    patient_keys: list = []
    patient_index: dict = {}
    for p in patients:
        if p not in patient_index:
            patient_index[p] = len(patient_keys)
            patient_keys.append(p)
    for x in phenx:
        if x not in phenx_index:
            phenx_index[x] = len(phenx_strings)
            phenx_strings.append(x)
    return Vocab(phenx_strings, patient_keys, phenx_index, patient_index)


def encode_rows(
    patients: Sequence, dates: Sequence[int], phenx: Sequence[str], vocab: Vocab | None = None
):
    """Alphanumeric rows -> numeric (patient_id, date, phenx_id) numpy arrays."""
    if vocab is None:
        vocab = build_vocab(patients, phenx)
    pid = np.fromiter((vocab.patient_index[p] for p in patients), np.int32, len(patients))
    xid = np.fromiter((vocab.phenx_index[x] for x in phenx), np.int32, len(phenx))
    return pid, np.asarray(dates, np.int32), xid, vocab
