"""A numpy emulation of K1's fp32 order (heat_tpu_torch/core/kernels/csrc/kmeans_assign.cu),
for the CPU tests: the card's kernel cannot run here, so its arithmetic is replayed step by
step in float32 on the plan the wrapper would launch and a given grid of blocks.

- d² of a row: with the centers in registers (d <= 64, k <= 8) each of the row's 4 threads
  runs one fused multiply-add chain over its chunks q, q + 4, ... (x, y, z, w in turn) and
  the 4 are added by two xor shuffles; otherwise each thread keeps 4 chains (one per lane of
  a chunk) over its chunks, adds them in pairs, and the row's threads add theirs by
  shuffles. |c|² is summed as the products with the centers in registers, else as 4 chains
  over all chunks added in pairs. Then
  max((|x|² + |c|²) − 2·x·c, 0), and the first j of the minimum (strict <).
- the sums, the counts and the sse follow ``kmeans.ordered_sums``'s order, written out here
  row by row, independently of it: tiles of rows, each block's tiles in turn, a tile's rows
  of a cluster in row order, the blocks' records folded in groups of 16; the sse by row
  slot, runs of slots, and the same fold.

A fused multiply-add is emulated in float64 and rounded once to float32: the product of two
float32 values is exact in float64, so only the rare sums that round twice can differ from
the card by one unit in the last place. The tests compare the emulation with tolerances
where that matters, and with float64 exactly on integer data, where nothing rounds.
"""

from __future__ import annotations

import numpy as np

from heat_tpu_torch.core.kernels import kmeans as k1

F32 = np.float32


def _fma(a, b, c):
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(F32)


def _quad(parts):
    """The row's thread partials added as the xor butterfly adds them."""
    if len(parts) == 1:
        return parts[0]
    if len(parts) == 2:
        return (parts[0] + parts[1]).astype(F32)
    return ((parts[0] + parts[1]).astype(F32) + (parts[2] + parts[3]).astype(F32)).astype(F32)


def _products(xs, cs, p):
    """(n, k) x·c and (n,) |x|² in the kernel's order; xs (n, chunks, 4), cs (k, chunks, 4)."""
    n, k = xs.shape[0], cs.shape[0]
    dots, sq = [], []
    for q in range(p.tpr):
        own = range(q, p.chunks, p.tpr)
        if p.reg:
            dot, xx = np.zeros((n, k), F32), np.zeros(n, F32)
            for ch in own:
                for e in range(4):
                    dot = _fma(xs[:, None, ch, e], cs[None, :, ch, e], dot)
                    xx = _fma(xs[:, ch, e], xs[:, ch, e], xx)
        else:
            pd, px = np.zeros((n, k, 4), F32), np.zeros((n, 4), F32)
            for ch in own:
                pd = _fma(xs[:, None, ch, :], cs[None, :, ch, :], pd)
                px = _fma(xs[:, ch, :], xs[:, ch, :], px)
            dot = ((pd[..., 0] + pd[..., 1]).astype(F32) + (pd[..., 2] + pd[..., 3]).astype(F32)).astype(F32)
            xx = ((px[:, 0] + px[:, 1]).astype(F32) + (px[:, 2] + px[:, 3]).astype(F32)).astype(F32)
        dots.append(dot)
        sq.append(xx)
    return _quad(dots), _quad(sq)


def emulate(x: np.ndarray, c: np.ndarray, blocks: int, launch=None) -> dict:
    """K1 on ``x`` (n, d) and ``c`` (k, d) f32 in the kernel's order, on a grid of ``blocks``
    blocks and the plan ``launch`` (``kmeans.plan``'s by default): labels, sums, counts,
    sse, each row's minimum d², and ``depth``, the most roundings a term of the sums can pass
    through in this order on these labels (the most rows of one cluster in its tile, plus
    that tile's block's tiles, plus the fold's additions)."""
    x = np.asarray(x, F32)
    c = np.asarray(c, F32)
    n, d = x.shape
    k = c.shape[0]
    p = launch or k1.plan(d, k)
    w = 4 * p.chunks
    xs = np.zeros((n, w), F32)
    xs[:, :d] = x
    cs = np.zeros((k, w), F32)
    cs[:, :d] = c
    xs, cs = xs.reshape(n, p.chunks, 4), cs.reshape(k, p.chunks, 4)

    if p.reg:  # |c|² as the products: each thread's running sum, the quad's four added
        parts = []
        for q in range(p.tpr):
            sq = np.zeros(k, F32)
            for ch in range(q, p.chunks, p.tpr):
                for e in range(4):
                    sq = _fma(cs[:, ch, e], cs[:, ch, e], sq)
            parts.append(sq)
        cc = _quad(parts)
    else:  # 4 running sums over all chunks, added in pairs
        pc = np.zeros((k, 4), F32)
        for ch in range(p.chunks):
            pc = _fma(cs[:, ch, :], cs[:, ch, :], pc)
        cc = ((pc[:, 0] + pc[:, 1]).astype(F32) + (pc[:, 2] + pc[:, 3]).astype(F32)).astype(F32)
    dot, xx = _products(xs, cs, p)
    d2 = np.maximum(((xx[:, None] + cc[None, :]).astype(F32) - (F32(2) * dot).astype(F32)).astype(F32), F32(0))
    labels = np.argmin(d2, axis=1).astype(np.int32)  # the first index of the minimum
    best = d2[np.arange(n), labels]

    bn = p.rows_per_tile
    tiles = -(-n // bn)
    fold = blocks if blocks <= 16 else 16 + -(-blocks // 16)  # a record's additions in the fold
    records = np.zeros((blocks, k, d), F32)
    slots = np.zeros((blocks, bn), F32)  # each tile row's slot of its block's sse
    tiles_of = np.zeros(blocks, np.int64)
    most = []  # (block, most rows of one cluster) of each tile
    for t in range(tiles):
        b = t % blocks
        tiles_of[b] += 1
        part = np.zeros((k, d), F32)
        seen = np.zeros(k, np.int64)
        for i in range(t * bn, min(n, (t + 1) * bn)):
            j = labels[i]
            part[j] = (part[j] + x[i]).astype(F32)
            seen[j] += 1
            slots[b, i - t * bn] = (slots[b, i - t * bn] + best[i]).astype(F32)
        records[b] = (records[b] + part).astype(F32)
        most.append((b, int(seen.max())))
    run = -(-bn // 32)
    block_sse = np.zeros(blocks, F32)
    for b in range(blocks):
        for lane in range(32):
            part = F32(0)
            for r in range(lane * run, min(bn, (lane + 1) * run)):
                part = F32(part + slots[b, r])
            block_sse[b] = F32(block_sse[b] + part)
    # the fold: groups of 16 blocks in block order, then the groups in group order
    group_sums, group_sse = [], []
    for g0 in range(0, blocks, 16):
        s, e = np.zeros((k, d), F32), F32(0)
        for b in range(g0, min(blocks, g0 + 16)):
            s, e = (s + records[b]).astype(F32), F32(e + block_sse[b])
        group_sums.append(s)
        group_sse.append(e)
    sums, sse = group_sums[0], group_sse[0]
    if len(group_sums) > 1:
        sums, sse = np.zeros((k, d), F32), F32(0)
        for s, e in zip(group_sums, group_sse):
            sums, sse = (sums + s).astype(F32), F32(sse + e)
    counts = np.bincount(labels, minlength=k).astype(F32)
    return {
        "labels": labels,
        "sums": sums,
        "counts": counts,
        "sse": sse,
        "best": best,
        "depth": max(m + int(tiles_of[b]) for b, m in most) + fold if tiles else 0,
    }
