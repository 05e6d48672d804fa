"""Sequence packing for the text serving path.

Host copy of ``misinfo_tpu/preprocess/packing.py``, importable without
JAX; held to the original by tests/test_torch_host.py.

The reference pads every request to a fixed max length and runs them one at
a time (misinfo_forensics.py:327-333). Our engine already length-buckets
(64/128/256/512); packing goes further for ragged traffic: multiple requests
share one row of the [R, L] token matrix, separated by segment ids, with
block-diagonal attention (ops/attention.py `segment_ids`) and per-segment
position ids. The RoBERTa FLOPs then scale with the *sum* of request
lengths instead of `num_requests × bucket_len`.

Packing is host-side and cheap (greedy first-fit decreasing); scores are
independent of co-packed neighbours (tests/test_packing.py asserts parity
with the unpacked path).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


@dataclass
class PackedTextBatch:
    """Device-ready packed token batch.

    ``ids/mask/position_ids/segment_ids`` are [R, L]; ``cls_rows/cls_cols``
    are [N] gather indices of each original request's <s> (CLS) token in
    the packed matrix, in the original request order. Slots beyond the real
    request count (N padded up to a batch bucket) point at (0, 0); callers
    discard those scores.
    """

    ids: np.ndarray
    mask: np.ndarray
    position_ids: np.ndarray
    segment_ids: np.ndarray
    cls_rows: np.ndarray
    cls_cols: np.ndarray
    n_real: int


def pack_token_rows(
    sequences: Sequence[np.ndarray],
    row_len: int,
    pad_id: int,
    *,
    n_slots: int = 0,
    min_rows: int = 0,
) -> PackedTextBatch:
    """Greedy first-fit-decreasing packing of token sequences into rows.

    Every sequence must fit in ``row_len`` (truncate upstream). Position ids
    follow the RoBERTa offset rule per segment (pad_id + 1 + offset —
    models/roberta.py `_position_ids` applied as if each segment were its
    own row). ``n_slots`` pads the CLS gather arrays; ``min_rows`` pads the
    row count (both keep jit signatures bucketed).
    """
    lens = [len(s) for s in sequences]
    if any(l > row_len for l in lens):
        raise ValueError(f"sequence longer than row_len={row_len}")
    order = sorted(range(len(sequences)), key=lambda i: -lens[i])

    free: List[int] = []            # remaining capacity per row
    placement: List[Tuple[int, int]] = [(0, 0)] * len(sequences)
    for i in order:
        n = lens[i]
        if n == 0:
            n = 1  # empty text still owns a CLS slot (tokenizer emits <s></s>)
        for r, cap in enumerate(free):
            if cap >= n:
                placement[i] = (r, row_len - cap)
                free[r] = cap - n
                break
        else:
            free.append(row_len - n)
            placement[i] = (len(free) - 1, 0)

    R = max(len(free), min_rows, 1)
    ids = np.full((R, row_len), pad_id, np.int32)
    mask = np.zeros((R, row_len), np.int32)
    seg = np.zeros((R, row_len), np.int32)
    pos = np.full((R, row_len), pad_id, np.int32)
    seg_counter = np.zeros(R, np.int32)

    N = max(n_slots, len(sequences))
    cls_rows = np.zeros(N, np.int32)
    cls_cols = np.zeros(N, np.int32)
    for i, s in enumerate(sequences):
        r, c = placement[i]
        n = max(len(s), 1)
        tok = np.asarray(s, np.int32) if len(s) else np.asarray([pad_id], np.int32)
        ids[r, c:c + n] = tok
        mask[r, c:c + n] = 1
        seg_counter[r] += 1
        seg[r, c:c + n] = seg_counter[r]
        pos[r, c:c + n] = pad_id + 1 + np.arange(n, dtype=np.int32)
        cls_rows[i], cls_cols[i] = r, c
    return PackedTextBatch(ids, mask, pos, seg, cls_rows, cls_cols,
                           n_real=len(sequences))


def pad_packed_rows(packed: PackedTextBatch, min_rows: int,
                    pad_id: int) -> PackedTextBatch:
    """Pad a packed batch's row count up to ``min_rows`` (row-count
    bucketing) without re-running the pack. Padded rows are all-padding
    (mask 0, segment 0) and own no CLS slots — identical to what
    ``pack_token_rows(..., min_rows=...)`` would have produced, letting the
    engine's auto-pack decision reuse its trial pack instead of packing the
    same sequences twice (ADVICE r1)."""
    R, L = packed.ids.shape
    if R >= min_rows:
        return packed
    extra = min_rows - R
    return PackedTextBatch(
        ids=np.concatenate([packed.ids, np.full((extra, L), pad_id, np.int32)]),
        mask=np.concatenate([packed.mask, np.zeros((extra, L), np.int32)]),
        position_ids=np.concatenate(
            [packed.position_ids, np.full((extra, L), pad_id, np.int32)]),
        segment_ids=np.concatenate(
            [packed.segment_ids, np.zeros((extra, L), np.int32)]),
        cls_rows=packed.cls_rows, cls_cols=packed.cls_cols,
        n_real=packed.n_real)


def trim_padded(ids: np.ndarray, mask: np.ndarray) -> List[np.ndarray]:
    """Split a padded [B, L] token matrix back into per-row unpadded lists
    (inverse of tokenizer .batch padding; feed to pack_token_rows)."""
    out = []
    for row_ids, row_mask in zip(ids, mask):
        out.append(np.asarray(row_ids[: int(row_mask.sum())], np.int32))
    return out


class StreamPacker:
    """Incremental first-fit packer for TRAINING batches with static shapes.

    Unlike serving (where row count adapts per batch), training wants one
    jit signature: exactly ``n_rows`` rows × ``row_len`` tokens with
    ``n_slots`` CLS slots per emitted batch. `add()` places sequences
    first-fit until the next one doesn't fit (rows exhausted or slots
    full), at which point the full batch is returned and the sequence
    seeds the next one. Examples-per-step therefore varies; the loss
    weights by ``slot_valid`` (train/steps.py packed step).
    """

    def __init__(self, row_len: int, pad_id: int, n_rows: int, n_slots: int):
        self.row_len, self.pad_id = row_len, pad_id
        self.n_rows, self.n_slots = n_rows, n_slots
        self._reset()

    def _reset(self):
        self._free = [self.row_len] * self.n_rows
        self._items: List[Tuple[int, int, np.ndarray, object]] = []  # row, col, seq, meta

    def _try_place(self, seq) -> bool:
        n = max(len(seq), 1)
        if len(self._items) >= self.n_slots:
            return False
        for r, cap in enumerate(self._free):
            if cap >= n:
                self._items.append((r, self.row_len - cap, seq, None))
                self._free[r] = cap - n
                return True
        return False

    def add(self, seq: np.ndarray, meta=None):
        """→ a finished (PackedTextBatch, metas) when this sequence forced a
        flush, else None. The sequence always ends up in some batch."""
        if len(seq) > self.row_len:
            raise ValueError(f"sequence longer than row_len={self.row_len}")
        if self._try_place(seq):
            self._items[-1] = self._items[-1][:3] + (meta,)
            return None
        out = self.flush()
        assert self._try_place(seq)
        self._items[-1] = self._items[-1][:3] + (meta,)
        return out

    def flush(self):
        """Emit the current batch (or None if empty) and reset."""
        if not self._items:
            return None
        R, L = self.n_rows, self.row_len
        ids = np.full((R, L), self.pad_id, np.int32)
        mask = np.zeros((R, L), np.int32)
        seg = np.zeros((R, L), np.int32)
        pos = np.full((R, L), self.pad_id, np.int32)
        seg_counter = np.zeros(R, np.int32)
        cls_rows = np.zeros(self.n_slots, np.int32)
        cls_cols = np.zeros(self.n_slots, np.int32)
        metas = []
        for i, (r, c, seq, meta) in enumerate(self._items):
            n = max(len(seq), 1)
            tok = (np.asarray(seq, np.int32) if len(seq)
                   else np.asarray([self.pad_id], np.int32))
            ids[r, c:c + n] = tok
            mask[r, c:c + n] = 1
            seg_counter[r] += 1
            seg[r, c:c + n] = seg_counter[r]
            pos[r, c:c + n] = self.pad_id + 1 + np.arange(n, dtype=np.int32)
            cls_rows[i], cls_cols[i] = r, c
            metas.append(meta)
        batch = PackedTextBatch(ids, mask, pos, seg, cls_rows, cls_cols,
                                n_real=len(self._items))
        self._reset()
        return batch, metas


def packed_row_bucket(n_rows: int, buckets: Sequence[int]) -> int:
    """Smallest bucket ≥ n_rows (last bucket if none fits — callers split)."""
    for b in buckets:
        if n_rows <= b:
            return b
    return buckets[-1]


def dense_rows_from_seqs(seqs: Sequence[np.ndarray], n_rows: int,
                         row_len: int, pad_id: int):
    """Unpacked [n_rows, row_len] ids/mask from trimmed sequences — lets the
    auto-pack path reuse its tokenization when the decision lands on the
    dense layout (rows beyond len(seqs) are all-padding; their scores are
    discarded by the caller)."""
    ids = np.full((n_rows, row_len), pad_id, np.int32)
    mask = np.zeros((n_rows, row_len), np.int32)
    for i, s in enumerate(seqs[:n_rows]):
        L = min(len(s), row_len)
        ids[i, :L] = s[:L]
        mask[i, :L] = 1
    return ids, mask
