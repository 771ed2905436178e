"""Device-side temporal segmentation, vectorised over config columns.

The counterpart of ``mvtrim_tpu/ops/segmentation.py``.  The authoritative
segmentation runs on the host in float64 (``core/oracle.py``, bit-parity
with pipeline.cpp:321-356).  This op is the streaming variant that
``tools/tune.py --device-stats`` runs over the whole config grid at the end
of a sweep, so the motion columns never leave the device before it.

Semantics mirror the oracle, in float32: over the motion timestamps of a
column (sorted, in order), a new segment starts when the gap to the
previous motion timestamp exceeds max_gap (strict >, the f32 difference);
each segment is padded, clamped to [0, duration] and masked.  The first
``max_segments`` segments are kept and the count saturates there.  Where
the JAX op carries a ``lax.scan`` over the frames, this op is a handful of
whole-tensor operations (cumulative max and sum, one scatter each for the
starts and the ends), so it launches the same few kernels for any N.
"""

from __future__ import annotations

import torch


def segment_op(ts: torch.Tensor, motion: torch.Tensor, duration: float, *,
               max_segments: int, max_gap_sec: float, padding_sec: float):
    """(ts f32 [N >= 1] sorted, motion bool [N, K], duration) -> (starts f32
    [K, S], ends f32 [K, S], count int32 [K], kept_seconds f32 [K]), S =
    max_segments.

    Each column of ``motion`` is segmented on its own, as the JAX op
    vmapped over the columns gives it.
    """
    n, k = motion.shape
    dev = motion.device
    s = max_segments
    ts = ts.to(device=dev, dtype=torch.float32)
    gap = torch.tensor(max_gap_sec, dtype=torch.float32, device=dev)
    pad = torch.tensor(padding_sec, dtype=torch.float32, device=dev)
    dur = torch.tensor(duration, dtype=torch.float32, device=dev)
    m = motion.t()                                          # [K, N]
    idx = torch.arange(n, device=dev).expand(k, n)
    none = torch.full((k, 1), -1, dtype=idx.dtype, device=dev)
    # the motion frame before each frame (-1: none) and after it (n: none)
    prev = torch.cat([none, torch.where(m, idx, -1).cummax(
        dim=1).values[:, :-1]], dim=1)
    nxt = torch.cat([torch.where(m, idx, n).flip(1).cummin(
        dim=1).values.flip(1)[:, 1:], none + n + 1], dim=1)
    t = ts.expand(k, n)
    opens = m & ((prev < 0) | (t - ts[prev.clamp(min=0)] > gap))
    seg = opens.cumsum(dim=1) - 1                           # segment id
    count = opens.sum(dim=1).clamp(max=s).to(torch.int32)
    # a motion frame closes its segment when the next motion frame opens
    # one, or when there is none
    closes = m & ((nxt >= n) | opens.gather(1, nxt.clamp(max=n - 1)))
    # slot S is a sink for the writes past capacity, dropped below
    starts = torch.zeros((k, s + 1), dtype=torch.float32, device=dev)
    ends = torch.zeros((k, s + 1), dtype=torch.float32, device=dev)
    slot = seg.clamp(max=s)
    starts.scatter_(1, torch.where(opens, slot, s),
                    torch.clamp(t - pad, min=0.0))
    ends.scatter_(1, torch.where(closes, slot, s), t + pad)
    starts, ends = starts[:, :s], ends[:, :s]
    valid = torch.arange(s, device=dev)[None, :] < count[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    ends = torch.where(valid, torch.minimum(ends, dur), zero)
    starts = torch.where(valid, torch.minimum(starts, ends), zero)
    kept = torch.where(valid, ends - starts, zero).sum(dim=1)
    return starts, ends, count, kept
