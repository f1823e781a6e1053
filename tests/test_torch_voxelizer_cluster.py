"""The voxelizer's cluster kernels: their rules, mirrored on the CPU.

The kernels (``csrc/voxelizer.cu``: K1 ``hist_frame_cluster_kernel``, K2
and K3 ``hist_scaled_cluster_kernel``) run one thread-block cluster of C
CTAs per window, the window's count frame cut into C bands of
``band_rows(H, C)`` rows; ``scale_counts_cluster_kernel`` (K2's and K3's
function over K1's counts) cuts a window's counts into C slices.  What
decides their results besides the arithmetic of the plain versions is
bookkeeping: which CTA owns a cell, which output rows a CTA writes and
which neighbour row it reads, how the events and the counts are sliced,
where K1's and K2's bands lie in shared memory against their 16-byte output
groups, how the count-of-counts tables of the bands and slices merge, and
the bisection driven by the k-th smallest |count| alone.  These tests state
each rule in numpy, as the kernel computes it, and hold it exhaustively
against what it must equal: ``_taps`` (the resize taps), the dense
count-of-counts of the plain version's counts and its quantile (exact), the
plain ``bisect_abs_quantile`` (bit for bit), and the JAX package's functions
(K1 exact, K2 within 2e-5 and K3 within 3e-5, the JAX package's bounds,
tests/test_fused_voxelizer.py:34,68).  The kernels themselves run only on
the card: the ``gpu`` tests below, and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from evfly_tpu.ops import voxelizer as jvox
from evfly_tpu_torch.ops import percentile, voxelizer
from evfly_tpu_torch.ops.imageops import resize_matrix
from torch_helpers import cuda_device  # noqa: F401  (fixture)

ATOL = 3e-5
K_SMALL = 4   # the kernel's kSmall: |count| below it is counted in registers,
K_TABLE = 64  # kTable: below it in a dense table, from it on in a list
CLUSTERS = (1, 2, 4, 8, 16)


def _events(seed, B, N, H, W):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, W, (B, N)).astype(np.float32)
    y = rng.uniform(0, H, (B, N)).astype(np.float32)
    p = rng.choice([-1, 1], (B, N)).astype(np.int32)
    return x, y, p


def _bands(H, C):
    """[(row0, row_end)] of each CTA, as the kernel bounds them."""
    rows = voxelizer.band_rows(H, C)
    return [(r * rows, min((r + 1) * rows, H)) for r in range(C)]


# ------------------------------------------------------------ band ownership

RESIZES = [(260, 346, 60, 90, False), (64, 86, 20, 26, False), (37, 41, 11, 13, False),
           (15, 20, 16, 26, True)]


@pytest.mark.parametrize("C", CLUSTERS)
@pytest.mark.parametrize("H,W,ho,wo,align", RESIZES, ids=lambda v: str(v))
def test_band_ownership_against_the_taps(H, W, ho, wo, align, C):
    """Every cell has one owner, ``idx // (rows * W)`` (the kernel's
    ``idx / band_cells``); every output row is written by exactly the CTA
    whose band holds its first tap row; the second tap row is that row or
    the next, and where it leaves the band it is the first row of the next
    CTA's band, the one row read through distributed shared memory."""
    rows = voxelizer.band_rows(H, C)
    bands = _bands(H, C)
    idx = np.arange(H * W)
    owner = idx // (rows * W)
    np.testing.assert_array_equal(owner, (idx // W) // rows)
    for r, (row0, row_end) in enumerate(bands):
        assert np.all((owner == r) == ((idx // W >= row0) & (idx // W < row_end)))
    taps, rh, _ = voxelizer._resize_operators(H, W, ho, wo, align, torch.device("cpu"))
    np.testing.assert_array_equal(rh.numpy(), resize_matrix(H, ho, align))
    th = taps[:ho].numpy()
    tw = taps[ho:].numpy()
    writers = np.zeros(ho, np.int64)
    for r, (row0, row_end) in enumerate(bands):
        for i in range(ho):
            h0, h1 = int(th[i, 0]), int(th[i, 1])
            if not row0 <= h0 < row_end:
                continue
            writers[i] += 1
            assert h1 in (h0, h0 + 1)
            if h1 >= row_end:
                assert h1 == row_end == bands[r + 1][0] and h1 // rows == r + 1
    np.testing.assert_array_equal(writers, np.ones(ho))
    assert tw[:, :2].max() < W and th[:, :2].max() < H


@pytest.mark.parametrize("N", [0, 1, 5, 37, 4999, 5000, 100000])
@pytest.mark.parametrize("C", [1, 3, 8, 16])
def test_event_slices_cover_each_event_once(N, C):
    """The kernel's ``event_slice``: CTA r reads [e0, e1), a multiple of 4
    events from the window's start, so every slice has the first's
    alignment; the slices cover the window once."""
    per = (-(-N // C) + 3) // 4 * 4  # ceil(N / C), rounded up to a multiple of 4
    seen = np.zeros(N, np.int64)
    for r in range(C):
        e0 = min(N, r * per)
        e1 = min(N, e0 + per)
        assert e0 % 4 == 0 or e0 == N
        seen[e0:e1] += 1
    np.testing.assert_array_equal(seen, np.ones(N))


@pytest.mark.parametrize("lead", [0, 1, 2, 3])
@pytest.mark.parametrize("cells", [0, 1, 2, 3, 4, 5, 11418, 346])
def test_k1_band_writes_cover_the_band_in_aligned_groups(lead, cells):
    """K1 keeps cell i of its band at shared word lead + i, lead being the
    output word offset of the band's first cell mod 4; it writes the words
    before the first whole group and after the last one by one and each
    whole group of 4 as one int4 -> float4.  Every cell is written once and
    every group lies inside the band."""
    end = lead + cells
    g0, g1 = min((lead + 3) // 4, end // 4), end // 4
    written = np.zeros(end + 4, np.int64)
    written[lead:min(4 * g0, end)] += 1
    for g in range(g0, g1):
        assert lead <= 4 * g and 4 * g + 4 <= end
        written[4 * g:4 * g + 4] += 1
    written[max(4 * g1, lead):end] += 1
    np.testing.assert_array_equal(written[lead:end], np.ones(cells))
    assert written[:lead].sum() == 0 and written[end:].sum() == 0


# ------------------------------------------------- count-of-counts and quantile


def _cluster_quantile(counts, n_events, C, kth, iters=18):
    """numpy mirror of K3's cluster kernel, steps 3 and 4, for one window's
    (H, W) int counts of n_events events: each band adds its counts of
    |count| < K_TABLE into every CTA's table and its larger ones into every
    CTA's list (at most n_events // K_TABLE in all), and its max into every
    CTA's; each CTA then prefix-sums its table and bisects, counting the
    list beyond the table.  Returns (table, list, q)."""
    H, W = counts.shape
    table = np.zeros(K_TABLE, np.int64)
    large, maxv = [], 0
    for row0, row_end in _bands(H, C):
        a = np.abs(counts[row0:row_end]).ravel()
        band_table = np.zeros(K_TABLE, np.int64)
        for v in range(K_SMALL):
            band_table[v] = (a == v).sum()
        for v in a[(a >= K_SMALL) & (a < K_TABLE)]:
            band_table[v] += 1
        band_list = a[a >= K_TABLE]
        assert band_list.size <= n_events // K_TABLE
        table += band_table
        large.extend(band_list.tolist())
        maxv = max(maxv, int(a.max()) if a.size else 0)
    assert len(large) <= n_events // K_TABLE
    cdf = np.cumsum(table)
    large = np.asarray(large, np.int64)

    def cdf_at(m):
        return cdf[m] if m < K_TABLE else cdf[-1] + int((large <= m).sum())

    lo, hi = np.float32(0), np.float32(maxv)
    for _ in range(iters):
        mid = np.float32(0.5) * (lo + hi)
        m = min(int(np.floor(mid)), maxv)
        if cdf_at(m) < kth:
            lo = mid
        else:
            hi = mid
    return table, large, (np.float32(0) if cdf[0] >= kth else hi)


def _counting_windows(seed, H, W):
    """(name, x, y, p) windows: uniform events; + and - events that cancel on
    the same cells; a hot pixel past int16; a patch of counts past the dense
    table; none."""
    rng = np.random.default_rng(seed)
    x, y, p = (a[0] for a in _events(seed, 1, 5000, H, W))
    cx = np.floor(rng.uniform(0, W, 300)).astype(np.float32) + 0.5
    cy = np.floor(rng.uniform(0, H, 300)).astype(np.float32) + 0.5
    cancel = (np.concatenate([x, cx, cx]), np.concatenate([y, cy, cy]),
              np.concatenate([p, np.ones(300, np.int32), -np.ones(300, np.int32)]))
    hot = (np.concatenate([x, np.full(40000, 7.5, np.float32)]),
           np.concatenate([y, np.full(40000, 3.5, np.float32)]),
           np.concatenate([p, np.ones(40000, np.int32)]))
    px = rng.uniform(0, 6, 20000).astype(np.float32) + 3
    py = rng.uniform(0, 6, 20000).astype(np.float32) + H // 2 - 3  # across band edges
    patch = (np.concatenate([x, px]), np.concatenate([y, py]),
             np.concatenate([p, rng.choice([-1, 1, 1], 20000).astype(np.int32)]))
    empty = (np.zeros(0, np.float32), np.zeros(0, np.float32), np.zeros(0, np.int32))
    return {"uniform": (x, y, p), "cancelling": cancel, "hot": hot, "patch": patch,
            "empty": empty}


@pytest.mark.parametrize("C", [2, 8, 16])
@pytest.mark.parametrize("kind", ["uniform", "cancelling", "hot", "patch", "empty"])
@pytest.mark.parametrize("H,W", [(260, 346), (37, 41)])
def test_band_tables_merge_into_the_dense_table_and_its_quantile(H, W, kind, C):
    """The per-band count-of-counts, merged, is the dense table of the
    plain version's counts below 64 and the list of the larger ones, cells
    that cancel back to 0 counted as zeros; the bisection on them gives the
    plain version's quantile bit for bit."""
    x, y, p = (torch.from_numpy(a)[None] for a in _counting_windows(3, H, W)[kind])
    counts = voxelizer._signed_counts(x, y, p, H, W).reshape(H, W).numpy().astype(np.int64)
    if kind == "cancelling":  # cells with events whose count is 0
        touched = (np.floor(y[0, -300:].numpy()) * W + np.floor(x[0, -300:].numpy())).astype(int)
        assert (counts.ravel()[touched] == 0).any()
    kth = voxelizer._kth(0.97, H * W)
    table, large, q = _cluster_quantile(counts, x.shape[1], C, kth)
    a = np.abs(counts).ravel()
    dense = np.bincount(a, minlength=K_TABLE)
    np.testing.assert_array_equal(table, dense[:K_TABLE])
    np.testing.assert_array_equal(np.sort(large), np.sort(a[a >= K_TABLE]))
    assert table.sum() + large.size == H * W
    if kind in ("hot", "patch"):
        assert large.size > 0
    _, qref = voxelizer.hist_scaled_resized_plain(x, y, p, H, W, 11, 13)
    assert q == qref.item()


# ------------------------------------------- K3's int16 bands and its scan

K3_PACKED_THREADS = 512  # kPackedThreads: a CTA of K3 with int16 bands


def _packed_band(counts):
    """numpy mirror of ``Band<true>``: cell i in the low (even i) or high
    (odd i) half of word i // 2, built as the kernel does, by the signed
    +-1 and +-65536 adds of each event (int32 words, two's complement)."""
    words = np.zeros((counts.size + 1) // 2, np.int64)
    idx = np.arange(counts.size)
    np.add.at(words, idx >> 1, np.where(idx & 1, counts * 65536, counts))
    assert np.all(np.abs(words) < 2 ** 31)  # no word leaves int32
    return words.astype(np.int32)


def _decode(words):
    """``Band<true>::cells_of``: lo = the sign-extended low half, hi = (w -
    lo) >> 16."""
    w = words.astype(np.int64)
    lo = (w & 0xFFFF).astype(np.uint16).view(np.int16).astype(np.int64)
    hi = (w - lo) >> 16
    return np.stack([lo, hi], axis=1).ravel()


@pytest.mark.parametrize("cells", [1, 2, 7, 346, 45_010])
def test_packed_band_words_hold_two_int16_counts(cells):
    """Any int16 counts, +-32,767 and cells that cancel to 0 included, are
    recovered from their words exactly, whatever the order of the adds."""
    rng = np.random.default_rng(cells)
    counts = rng.integers(-3, 4, cells)
    counts[rng.integers(0, cells, min(cells, 6))] = [32767, -32767, 1, -1, 0, 5000][:min(cells, 6)]
    words = _packed_band(counts)
    np.testing.assert_array_equal(_decode(words)[:cells], counts)
    if cells % 2:  # the last word's high half is no cell and stays 0
        assert _decode(words)[cells] == 0
    # events one by one, in a random order, as the kernel's atomics land
    events = np.repeat(np.arange(cells), np.abs(counts))
    signs = np.repeat(np.sign(counts), np.abs(counts))
    order = rng.permutation(events.size)
    w = np.zeros((cells + 1) // 2, np.int64)
    for e, sg in zip(events[order][:20000], signs[order][:20000]):
        w[e >> 1] += sg * 65536 if e & 1 else sg
        assert -2 ** 31 <= w[e >> 1] < 2 ** 31
    if events.size <= 20000:
        np.testing.assert_array_equal(w, words)


def _moment_scan(cells_of_band, packed, threads=K3_PACKED_THREADS):
    """numpy mirror of K3's scan of one band: thread t takes the int4s t, t
    + threads, ... (8 cells each with int16 pairs, 4 with int32), then the
    cells past the last whole int4; over each cell a = |count| it sums
    [a > 0], a and a * a (mod 2^32) without a branch, and where a group's
    max reaches K_SMALL takes its cells with a >= K_SMALL out again (into
    the table or the list).  Returns #(|count| == v) for v < K_SMALL summed
    over the threads, the table's counts from K_SMALL on, and the list."""
    per = 8 if packed else 4
    n = cells_of_band.size
    a_all = np.abs(cells_of_band).tolist()
    M = 2 ** 32
    small = np.zeros(K_SMALL, np.int64)
    table = np.zeros(K_TABLE, np.int64)
    large = []
    for t in range(threads):
        groups = list(range(t, n // per, threads))
        tail = list(range(n // per * per + t, n, threads))
        nz = s1 = s2 = 0
        seen = n_rare = 0
        for cells in [a_all[g * per:(g + 1) * per] for g in groups] + [a_all[i:i + 1]
                                                                      for i in tail]:
            nz = (nz + sum(min(a, 1) for a in cells)) % M
            s1 = (s1 + sum(cells)) % M
            s2 = (s2 + sum(a * a % M for a in cells)) % M
            seen += len(cells)
            if max(cells) >= K_SMALL:
                for a in (a for a in cells if a >= K_SMALL):
                    nz, s1, s2 = (nz - 1) % M, (s1 - a) % M, (s2 - a * a) % M
                    n_rare += 1
                    if a < K_TABLE:
                        table[a] += 1
                    else:
                        large.append(a)
        n3 = (s2 - 3 * s1 + 2 * nz) % M // 2
        n2 = (s1 - nz - 2 * n3) % M
        n1 = (nz - n2 - n3) % M
        n0 = seen - n_rare - nz
        small += [n0, n1, n2, n3]
    return small, table, large


@pytest.mark.parametrize("kind,packed", [(kind, packed) for packed in (True, False)
                                         for kind in ("uniform", "cancelling", "patch", "empty")]
                         + [("hot", False)])  # a count past int16: int32 bands
def test_k3_scan_sums_give_the_dense_table(kind, packed):
    """The scan's three sums per thread give #(|count| == v) for v < 4, the
    rest goes to the table or list: together the dense count-of-counts of
    the plain version's counts, band by band, at 260x346 on 2 CTAs."""
    H, W, C = 260, 346, 2
    x, y, p = (torch.from_numpy(a)[None] for a in _counting_windows(5, H, W)[kind])
    counts = voxelizer._signed_counts(x, y, p, H, W).reshape(H, W).numpy().astype(np.int64)
    assert np.abs(counts).max() <= 32767 or not packed
    for row0, row_end in _bands(H, C):
        band = counts[row0:row_end].ravel()
        if packed:  # the scan reads the words' cells in the band's order
            band = _decode(_packed_band(band))[:band.size]
        small, table, large = _moment_scan(band, packed)
        dense = np.bincount(np.abs(band), minlength=K_TABLE)
        np.testing.assert_array_equal(small, dense[:K_SMALL])
        np.testing.assert_array_equal(table[K_SMALL:], dense[K_SMALL:K_TABLE])
        assert sorted(large) == sorted(np.abs(band)[np.abs(band) >= K_TABLE].tolist())


def _bisect(below, maxv, iters=18):
    lo, hi = np.float32(0), np.float32(maxv)
    for _ in range(iters):
        mid = np.float32(0.5) * (lo + hi)
        m = min(int(np.floor(mid)), maxv)
        if below(m):
            lo = mid
        else:
            hi = mid
    return hi


@pytest.mark.parametrize("seed", range(40))
def test_k3_bisection_reads_no_memory_where_the_table_holds_the_quantile(seed):
    """Where the table's CDF reaches kth, CDF[m] < kth is m < v, v the
    number of the table's CDF entries below kth (two ballots of a warp):
    the same 18 steps, the same quantile bit for bit, and v == 0 exactly
    when the zero snap applies."""
    rng = np.random.default_rng(seed)
    maxv = int(rng.choice([1, 2, 3, 5, 40, 63, 64, 200]))
    table = np.zeros(K_TABLE, np.int64)
    hist = rng.integers(0, 50, min(maxv, K_TABLE - 1) + 1)
    table[:hist.size] = hist
    table[0] += int(rng.integers(0, 5000))
    cdf = np.cumsum(table)
    total = int(cdf[-1]) + (int(rng.integers(1, 20)) if maxv >= K_TABLE else 0)
    for kth in sorted({1, int(cdf[0]), int(cdf[0]) + 1, int(cdf[-1]), total,
                       int(rng.integers(1, total + 1))}):
        if not 1 <= kth <= total:
            continue
        in_table = cdf[-1] >= kth
        v = int((cdf < kth).sum())
        ref = _bisect(lambda m: (cdf[m] if m < K_TABLE else total) < kth, maxv)
        q_ref = np.float32(0) if cdf[0] >= kth else ref
        if in_table:
            got = _bisect(lambda m: m < v, maxv)
            assert got == ref
            assert (v == 0) == (cdf[0] >= kth)
            assert (np.float32(0) if v == 0 else got) == q_ref
        else:
            assert v == K_TABLE and cdf[0] < kth


def test_count_to_float_is_exact():
    """``count_to_float``: the float of 1.5 * 2^23 + c, less 1.5 * 2^23, is
    c exactly for |c| < 2^22 (every count of a window K3 takes)."""
    c = np.arange(-(2 ** 22) + 1, 2 ** 22, dtype=np.int64)
    bits = (np.int64(0x4B400000) + c).astype(np.uint32).view(np.float32)
    got = bits - np.float32(12582912.0)
    np.testing.assert_array_equal(got, c.astype(np.float32))
    assert max(voxelizer.resized_cluster_cap(260, 346, 60, 90, C) for C in CLUSTERS) < 2 ** 22


@pytest.mark.parametrize("C", CLUSTERS)
@pytest.mark.parametrize("H,W", [(260, 346), (64, 86), (37, 41), (480, 640), (1, 60000)])
def test_k3_owner_from_a_float_estimate(H, W, C):
    """K3's owner of cell idx without an integer division: trunc(float(idx)
    * (1 / band_cells)), less one where it passes idx, plus one where the
    next band starts at or before idx, is idx // band_cells for every cell."""
    band_cells = voxelizer.band_rows(H, C) * W
    idx = np.arange(H * W, dtype=np.int64)
    inv = np.float32(1.0) / np.float32(band_cells)
    owner = np.trunc(idx.astype(np.float32) * inv).astype(np.int64)
    owner -= owner * band_cells > idx
    owner += (owner + 1) * band_cells <= idx
    np.testing.assert_array_equal(owner, idx // band_cells)


# ------------------------------------------------- K2's band, written as K1's


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("C", CLUSTERS)
@pytest.mark.parametrize("H,W", [(260, 346), (64, 86), (37, 41), (3, 5)])
def test_k2_band_writes_cover_every_cell_once(H, W, C, packed):
    """K2's CTA r keeps cell i of its band at slot lead(r) + i, lead(r) the
    output word offset of the band's first cell mod 4 (K1's layout), two
    slots a word when packed; it writes the slots before its first whole
    group and after its last one by one and each whole group of 4 slots (an
    int4, or two packed words) as one float4.  For every window of a batch
    and every alignment of the output, each cell of the frame is written
    once, every group is 16-byte aligned in the output, and every slot read
    lies inside the band array (``_scaled_band_words``)."""
    rows = voxelizer.band_rows(H, C)
    band_cells = rows * W
    stride = voxelizer._scaled_band_words(H, W, C, packed)
    slots_in_array = stride * (2 if packed else 1)
    for out_word in range(4):  # the output's first word mod 4
        for b in range(3):
            frame0 = b * H * W
            written = np.zeros(H * W, np.int64)
            for r, (row0, row_end) in enumerate(_bands(H, C)):
                lead = (out_word + frame0 + r * band_cells) % 4
                cells = max(0, row_end - row0) * W
                slots = lead + cells
                assert slots <= slots_in_array
                first = row0 * W - lead  # frame cell of slot 0
                g0, g1 = min((lead + 3) // 4, slots // 4), slots // 4
                singles = list(range(lead, min(4 * g0, slots))) + \
                    list(range(max(4 * g1, lead), slots))
                for s in singles:
                    written[first + s] += 1
                for g in range(g0, g1):
                    assert (out_word + frame0 + first + 4 * g) % 4 == 0
                    assert lead <= 4 * g and 4 * g + 4 <= slots
                    if packed:
                        assert 2 * g + 1 < stride
                    written[first + 4 * g:first + 4 * g + 4] += 1
            np.testing.assert_array_equal(written, np.ones(H * W))


def test_k2_band_with_its_lead_holds_the_counts():
    """A packed band built from slot lead + i, as K2's adds build it, gives
    back every count at its slot and zeros in the lead slots, so the scan's
    tally of the slots less the lead's zeros is the band's count-of-counts."""
    rng = np.random.default_rng(7)
    counts = rng.integers(-3, 4, 1001)
    counts[[0, 500, 1000]] = [32767, -32767, 70]
    for lead in range(4):
        slots = np.concatenate([np.zeros(lead, np.int64), counts])
        words = _packed_band(slots)
        decoded = _decode(words)[:slots.size]
        np.testing.assert_array_equal(decoded[lead:], counts)
        assert not decoded[:lead].any()
        small, table, large = _moment_scan(decoded, packed=True)
        small[0] -= lead  # thread 0 starts its count of cells at -lead
        dense = np.bincount(np.abs(counts), minlength=K_TABLE)
        np.testing.assert_array_equal(small, dense[:K_SMALL])
        np.testing.assert_array_equal(table[K_SMALL:], dense[K_SMALL:K_TABLE])
        assert sorted(large) == sorted(np.abs(counts)[np.abs(counts) >= K_TABLE].tolist())


# ------------------------------------- scale_counts: v_k, slices and the lists


def _bisect_by_kth_value(vk, maxv, iters=18):
    """The kernel's bisection driven by v_k alone: #(|count| <= mid) < kth is
    mid < v_k, and the zero snap #(|count| == 0) >= kth is v_k == 0 (f32)."""
    lo, hi, v = np.float32(0), np.float32(maxv), np.float32(vk)
    for _ in range(iters):
        mid = np.float32(0.5) * (lo + hi)
        if mid < v:
            lo = mid
        else:
            hi = mid
    return np.float32(0) if vk == 0 else hi


_COUNTS = {
    "small": st.integers(-5, 5),
    "past int16": st.integers(-(2 ** 24), 2 ** 24),  # f32 holds them exactly
    "zeros": st.just(0),
    "past the table": st.one_of(st.integers(-3, 3), st.integers(64, 5000),
                                st.integers(-5000, -64)),
}


@settings(max_examples=300, deadline=None, database=None, derandomize=True)
@given(data=st.data())
def test_bisection_driven_by_the_kth_value_equals_the_plain_one(data):
    """For any integer counts, the 18-step bisection of
    ``ops/percentile.bisect_abs_quantile`` (the plain version's) equals the
    one that compares mid with v_k, the k-th smallest |count|, bit for bit:
    counts past int16, all-zero windows and v_k past the dense table of 64
    included."""
    kind = data.draw(st.sampled_from(sorted(_COUNTS)))
    counts = np.asarray(data.draw(st.lists(_COUNTS[kind], min_size=1, max_size=300)),
                        np.int64)
    kth = data.draw(st.integers(1, counts.size))
    iters = data.draw(st.sampled_from([1, 5, 18, 30]))
    a = np.abs(counts)
    ref = percentile.bisect_abs_quantile(torch.from_numpy(a.astype(np.float32))[None], kth,
                                         iters).numpy()[0]
    vk = int(np.sort(a)[kth - 1])
    got = _bisect_by_kth_value(vk, int(a.max()), iters)
    assert got.tobytes() == np.float32(ref).tobytes()


def _scale_counts_model(counts, C, lead, kth, thresh=0.2, iters=18):
    """numpy mirror of ``scale_counts_cluster_kernel`` for one window's (H,
    W) integer counts whose first cell has word offset ``lead`` mod 4: CTA r
    takes slots [r * per, (r + 1) * per) of [lead, lead + H * W), tallies
    its whole groups with the scan's sums (``_moment_scan``, 512 threads)
    and its other cells one by one, its |count| >= 64 into its list at the
    offset of its first cell in the scratch; the parts merge slot by slot;
    v_k from the merged table's CDF or, past it, from a search by halving
    over the lists.  Returns (frame, q, v_k, entries in the lists)."""
    H, W = counts.shape
    HW = H * W
    flat = counts.ravel().astype(np.int64)
    per = voxelizer.scale_slice_slots(HW, C)
    assert per % 4 == 0 and C * per >= lead + HW
    scratch = np.full(HW, -1, np.int64)
    table, maxv, segments = np.zeros(K_TABLE, np.int64), 0, []
    covered = np.zeros(HW, np.int64)
    for r in range(C):
        s0 = max(lead, r * per)
        s1 = max(s0, min(lead + HW, (r + 1) * per))
        g0, g1 = min((s0 + 3) // 4, s1 // 4), s1 // 4
        grouped = flat[4 * g0 - lead:4 * g1 - lead] if g1 > g0 else flat[:0]
        singles = np.concatenate([flat[s0 - lead:max(s0, 4 * g0) - lead][:max(0, 4 * g0 - s0)],
                                  flat[max(4 * g1, s0) - lead:s1 - lead]])
        covered[s0 - lead:s1 - lead] += 1
        small, part, large = _moment_scan(grouped, packed=False)
        a1 = np.abs(singles)
        for v in a1:
            if v < K_TABLE:
                (small if v < K_SMALL else part)[v] += 1
            else:
                large.append(int(v))
        part[:K_SMALL] = small
        assert len(large) <= s1 - s0
        scratch[s0 - lead:s0 - lead + len(large)] = large
        segments.append((s0 - lead, len(large)))
        table += part
        cells = flat[s0 - lead:s1 - lead]
        maxv = max(maxv, int(np.abs(cells).max()) if cells.size else 0)
    np.testing.assert_array_equal(covered, np.ones(HW))
    lists = np.concatenate([scratch[o:o + n] for o, n in segments])
    below = int(table.sum())
    if below >= kth:
        vk = int((np.cumsum(table) < kth).sum())
    else:
        rank, lo, hi = kth - below, K_TABLE, maxv
        while lo < hi:
            mid = lo + (hi - lo) // 2
            if int((lists <= mid).sum()) >= rank:
                hi = mid
            else:
                lo = mid + 1
        vk = lo
    q = _bisect_by_kth_value(vk, maxv, iters)
    scale = np.float32(1) / max(q, np.float32(1e-30)) if q > 0 else np.float32(thresh)
    frame = np.clip(counts.astype(np.float32) * scale, np.float32(-1), np.float32(1))
    return frame, q, vk, lists.size


def _hot_window(seed, H, W, hot_events, n_hot=3):
    """5,000 uniform events and ``n_hot`` pixels of ``hot_events`` each."""
    rng = np.random.default_rng(seed)
    x, y, p = (a[0] for a in _events(seed, 1, 5000, H, W))
    hx = np.repeat(np.floor(rng.uniform(0, W, n_hot)) + 0.5, hot_events).astype(np.float32)
    hy = np.repeat(np.floor(rng.uniform(0, H, n_hot)) + 0.5, hot_events).astype(np.float32)
    hp = np.repeat(rng.choice([-1, 1], n_hot), hot_events).astype(np.int32)
    return np.concatenate([x, hx]), np.concatenate([y, hy]), np.concatenate([p, hp])


@pytest.mark.parametrize("C", [4, 8, 16])
@pytest.mark.parametrize("lead", [0, 1, 2, 3])
@pytest.mark.parametrize("kind", ["uniform", "hot", "deep"])
def test_scale_counts_model_matches_the_plain_version(kind, lead, C):
    """The slices, the tables and lists merged through the slots, and the
    bisection on v_k give ``scale_counts_plain``'s quantile and frame bit for
    bit at 64x86: uniform events, hot pixels past int16, and counts whose
    97th percentile passes the dense table (the search over the lists)."""
    H, W = 64, 86
    if kind == "deep":  # |count| around 100 on every cell
        counts = np.random.default_rng(lead + C).integers(60, 140, (H, W))
        counts *= np.random.default_rng(C).choice([-1, 1], (H, W))
    else:
        x, y, p = _hot_window(lead, H, W, 40000 if kind == "hot" else 0, 3 if kind == "hot" else 0)
        counts = voxelizer._signed_counts(*(torch.from_numpy(a)[None] for a in (x, y, p)),
                                          H, W).reshape(H, W).numpy().astype(np.int64)
    kth = voxelizer._kth(0.97, H * W)
    frame, q, vk, n_listed = _scale_counts_model(counts, C, lead, kth)
    ref, qref = voxelizer.scale_counts_plain(torch.from_numpy(counts.astype(np.float32))[None])
    assert q.tobytes() == qref.numpy()[0].tobytes()
    np.testing.assert_array_equal(frame, ref[0].numpy())
    if kind == "deep":
        assert vk >= K_TABLE and n_listed > 0
    if kind == "hot":
        assert np.abs(counts).max() > 32767 and n_listed == 3 and vk < K_TABLE


@pytest.mark.parametrize("kind", ["uniform", "hot"])
def test_scale_counts_model_matches_jax(kind):
    """The model on K1's counts of a window at 64x86, uniform or with two
    pixels past int16, against the JAX package's ``event_histogram_scaled``
    on its events (within 2e-5, the JAX package's bound; the quantile of its
    Pallas kernel exactly)."""
    H, W = 64, 86
    x, y, p = _hot_window(11, H, W, 34000 if kind == "hot" else 0, 2 if kind == "hot" else 0)
    counts = voxelizer.hist_frame_plain(*(torch.from_numpy(a)[None] for a in (x, y, p)),
                                        H, W, 1.0, 1.0)[0].numpy().astype(np.int64)
    frame, q, _, _ = _scale_counts_model(counts, 16, 2, voxelizer._kth(0.97, H * W))
    jx, jy, jp = (jnp.asarray(a) for a in (x, y, p))
    ref = np.asarray(jvox.event_histogram_scaled(jx, jy, jp, H, W))
    xi, yi, sign = jvox._bin_events(jx, jy, jp, H, W)
    _, qref = jvox._hist_pallas_fused_quantile(
        yi, xi, sign, H=H, W=W, chunk=512, interpret=True, q=0.97, iters=18)
    np.testing.assert_allclose(frame, ref, atol=2e-5)
    assert q == np.float32(qref)


@pytest.mark.parametrize("C", CLUSTERS)
@pytest.mark.parametrize("HW", [1, 3, 4, 5, 5504, 89960, 89961, 921600])
def test_scale_slices_cover_each_cell_once(HW, C):
    """Every CTA's slice is a multiple of 4 slots from a multiple of 4 on
    (but the first, which starts at lead), so every whole group is a
    16-byte load and store; the slices cover the window once whatever its
    lead; the frame kernel keeps a slice in shared memory where it fits."""
    per = voxelizer.scale_slice_slots(HW, C)
    for lead in range(4):
        seen = np.zeros(HW, np.int64)
        for r in range(C):
            s0 = max(lead, r * per)
            s1 = max(s0, min(lead + HW, (r + 1) * per))
            assert r == 0 or s0 % 4 == 0 or s0 == s1
            seen[s0 - lead:s1 - lead] += 1
        np.testing.assert_array_equal(seen, np.ones(HW))
    assert voxelizer.scale_slice_cached(HW, C) == (per * 4 <= voxelizer._SCALE_SMEM_LIMIT)
    assert voxelizer.scale_slice_cached(89960, 16)


# ----------------------------------------------------------------- fit rules


def test_cluster_caps_and_routes_by_shape():
    """K3 takes up to its cap: the band, the taps, a row and the window's
    list of the cells with |count| >= 64 (at most N / 64) in 231,424 bytes,
    763,135 events at 260x346 -> 60x90 on 2 CTAs (2,910,975 on 8), with
    int16 counts up to 32,767 events; K2's cap is unchanged; K1 takes its
    cluster kernel on 8 CTAs where their bands fit, else on 16 where those
    do, else its band route."""
    H, W, out = 260, 346, (60, 90)
    assert voxelizer.K3_CLUSTER == 2
    cap = voxelizer.resized_cluster_cap(H, W, *out)
    assert cap == 763135
    assert voxelizer.resized_cluster_cap(H, W, *out, cluster=8) == 2910975
    assert voxelizer.resized_cluster_smem(cap, H, W, *out) <= voxelizer._SMEM_LIMIT
    assert voxelizer.resized_cluster_smem(cap + 1, H, W, *out) > voxelizer._SMEM_LIMIT
    for n in (0, 5000, 20000, 32767, 32768, 40000, cap):
        assert voxelizer.scaled_route(n, H, W, out) == "cluster"
    assert voxelizer.scaled_route(cap + 1, H, W, out) == "k1"
    assert voxelizer.resized_packed(32767) and not voxelizer.resized_packed(32768)
    # K2's cluster kernel, with no taps and no row to copy, takes more than K3
    assert voxelizer.scaled_cluster_cap(H, W) == 823807 > cap
    for n in (5000, 20000, 32767, 32768, 823807):
        assert voxelizer.scaled_route(n, H, W) == "cluster"
    assert voxelizer.scaled_route(823808, H, W) == "k1"
    assert voxelizer.scaled_route(32767, 64, 86) == voxelizer.scaled_route(32768, 64, 86) \
        == "cluster"
    # one row too wide for a band and its copy: K1's counts
    assert voxelizer.resized_cluster_cap(1, 60000, 1, 10) == -1
    assert voxelizer.scaled_route(10, 1, 60000, (1, 10)) == "k1"
    # where the int32 band leaves less than 32,767 events, the packed one's
    # cap, at most 32,767
    assert voxelizer.resized_cluster_cap(260, 346, 60, 90, 1) == 32767
    assert voxelizer.resized_cluster_cap(420, 346, 60, 90, 2) == 32767
    assert voxelizer.k1_route(H, W, False) == voxelizer.k1_route(H, W, True) == ("cluster", 8)
    assert voxelizer.k1_route(64, 86, True) == ("cluster", 8)
    assert voxelizer.k1_route(4000, 4000, False) == ("band", 0)
    assert voxelizer.k1_route(480, 640, True) == ("cluster", 16)
    assert voxelizer.k1_route(480, 640, False) == ("cluster", 8)


@pytest.mark.parametrize("C", CLUSTERS)
def test_band_and_table_fit_shared_memory(C):
    """The rules' byte counts: a band of ceil(H / C) rows of int32 (two for
    two-pass K1), 3 words for K1's alignment, whole int4s; K3's band of
    int16 pairs (whole int4s) and its row of int16 pairs up to 32,767
    events, of int32 above."""
    H, W = 260, 346
    band = (-(-H // C) * W + 3 + 3) // 4 * 4
    assert voxelizer._band_ints(H, W, C) == band
    assert voxelizer.frame_cluster_fits(H, W, False, C) == (band * 4 <= voxelizer._SMEM_LIMIT)
    assert voxelizer.frame_cluster_fits(H, W, True, C) == (2 * band * 4 <= voxelizer._SMEM_LIMIT)
    pairs = ((-(-H // C) * W + 1) // 2 + 3) // 4 * 4
    lists = (5000 // 64 + 1 + 3) // 4 * 4
    assert voxelizer.resized_cluster_smem(5000, H, W, 60, 90, C) == \
        (pairs + lists + 600 + (W + 1) // 2) * 4
    lists = (40000 // 64 + 1 + 3) // 4 * 4
    assert voxelizer.resized_cluster_smem(40000, H, W, 60, 90, C) == \
        (band + lists + 600 + W) * 4
    assert not voxelizer.frame_cluster_fits(H, W, False, 0)
    assert not voxelizer.frame_cluster_fits(H, W, False, 17)


@pytest.mark.parametrize("C", CLUSTERS)
@pytest.mark.parametrize("H,W,ho,wo", [(260, 346, 60, 90), (64, 86, 20, 26), (480, 640, 60, 90),
                                        (37, 41, 11, 13)])
def test_k3_takes_every_count_up_to_its_cap(H, W, ho, wo, C):
    """Every N up to the cap fits a block's shared memory with the layout
    resized_packed(N) picks, the int16 bands up to 32,767 events and the
    int32 bands above, and the cap is the last N that does."""
    cap = voxelizer.resized_cluster_cap(H, W, ho, wo, C)

    def fits(n):
        return voxelizer.resized_cluster_smem(n, H, W, ho, wo, C) <= voxelizer._SMEM_LIMIT

    # within a layout the shared memory grows with N (the lists): its last
    # N fitting means every smaller one does
    assert fits(cap) == (cap >= 0) and fits(min(cap, 32767)) == (cap >= 0)
    assert not fits(cap + 1)
    if cap >= 0:
        assert all(fits(n) for n in (0, 1, 63, 64, min(cap, 32767)))


@pytest.mark.parametrize("C", CLUSTERS)
@pytest.mark.parametrize("H,W", [(260, 346), (64, 86), (480, 640), (37, 41)])
def test_k2_takes_every_count_up_to_its_cap(H, W, C):
    """K2's cap is the last N whose band and list fit a block's shared
    memory (int16 bands up to 32,767 events, int32 above), and at the
    sensor's shape every count of the rule's cases fits: 5,000, 20,000,
    32,767 (packed), 32,768 (int32)."""
    cap = voxelizer.scaled_cluster_cap(H, W, C)

    def fits(n):
        return voxelizer.scaled_cluster_smem(n, H, W, C) <= voxelizer._SMEM_LIMIT

    assert fits(cap) == (cap >= 0) and not fits(cap + 1)
    if cap >= 0:
        assert all(fits(n) for n in (0, 1, 63, 64, min(cap, 32767)))
        assert cap >= voxelizer.resized_cluster_cap(H, W, 60, 90, C)
    if (H, W) in ((260, 346), (64, 86)) and C == voxelizer.K2_CLUSTER:
        for n in (5000, 20000, 32767, 32768):
            assert fits(n) and voxelizer.scaled_route(n, H, W) == "cluster"
        assert voxelizer.resized_packed(32767) and not voxelizer.resized_packed(32768)
        # the packed band's words: half the band's slots, with K1's lead
        rows = voxelizer.band_rows(H, C)
        assert voxelizer.scaled_cluster_smem(5000, H, W, C) == \
            (((rows * W + 4) // 2 + 3) // 4 * 4 + (5000 // 64 + 1 + 3) // 4 * 4) * 4


# ------------------------------------------------------- the launchers on the CPU


def test_cluster_launchers_refuse_cpu_tensors():
    x, y, p = (torch.from_numpy(a) for a in _events(3, 1, 50, 16, 20))
    with pytest.raises(ValueError, match="unsupported device"):
        voxelizer._frame_cluster_launch(x, y, p, 16, 20, 0.2, 0.2, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        voxelizer._resized_cluster_launch(x, y, p, 16, 20, 8, 10, 0.2, 0.97, 18, False, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        voxelizer._scaled_cluster_launch(x, y, p, 16, 20, 0.2, 0.97, 18, 2)
    counts = voxelizer.hist_frame_plain(x, y, p, 16, 20, 1.0, 1.0)
    with pytest.raises(ValueError, match="counts on CUDA"):
        voxelizer._scale_launch("scale_counts", counts, 0.2, 0.97, 18, None)


# ------------------------------------------------------------ on the card


@pytest.mark.gpu
@pytest.mark.parametrize("thresholds", [(0.2, 0.2), (0.2, 0.3)], ids=["equal", "unequal"])
@pytest.mark.parametrize("B,N", [(1, 5000), (256, 5000), (3, 4999), (2, 100000)])
def test_k1_cluster_kernel_matches_plain_on_gpu(cuda_device, B, N, thresholds):
    x, y, p = (torch.from_numpy(a).to(cuda_device) for a in _events(8 + B, B, N, 260, 346))
    if N > 40000:
        x[:, :40000], y[:, :40000] = 17.5, 101.5
    before = voxelizer.hist_frame_cluster.launches
    got = voxelizer.hist_frame_cluster(x, y, p, 260, 346, *thresholds)
    assert voxelizer.hist_frame_cluster.launches == before + 1
    assert torch.equal(got, voxelizer.hist_frame_plain(x, y, p, 260, 346, *thresholds))


@pytest.mark.gpu
@pytest.mark.parametrize("B,N", [(16, 5000), (2, 80), (2, 20000), (2, 32767), (2, 40000),
                                 (2, 100000)])
def test_k3_cluster_kernel_matches_plain_on_gpu(cuda_device, B, N):
    x, y, p = (torch.from_numpy(a).to(cuda_device) for a in _events(9 + N, B, N, 260, 346))
    if N == 32767:  # int16 counts at +-32,000, on the last row of band 0
        x[:, :32000], y[:, :32000] = 200.5, 129.5
        p[0, :32000], p[1, :32000] = 1, -1
    if N == 40000:  # a count past int16
        x[0, :33000], y[0, :33000], p[0, :33000] = 100.5, 130.5, 1
    if N == 100000:  # 400 counts past the dense table, across a band edge
        x[:, :50000] = 150.0 + x[:, :50000] * (20.0 / 346)
        y[:, :50000] = 25.0 + y[:, :50000] * (20.0 / 260)
    before = voxelizer.hist_scaled_resized.launches
    out, q = voxelizer.hist_scaled_resized(x, y, p, 260, 346, 60, 90)
    assert voxelizer.hist_scaled_resized.launches == before + 1
    ref, qref = voxelizer.hist_scaled_resized_plain(x, y, p, 260, 346, 60, 90)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)
    assert torch.equal(q, qref)


@pytest.mark.gpu
def test_cluster_rules_match_the_library_on_gpu(cuda_device):
    from evfly_tpu_torch.ops import _build

    lib = _build.library()
    for h, w in ((1, 1), (64, 86), (260, 346), (720, 1280), (2000, 900)):
        for c in CLUSTERS:
            assert voxelizer.scaled_cluster_cap(h, w, c) == \
                lib.evfly_hist_scaled_cluster_cap(h, w, c)
            for ho, wo in ((60, 90), (h, w)):
                assert voxelizer.resized_cluster_cap(h, w, ho, wo, c) == \
                    lib.evfly_hist_resized_cluster_cap(h, w, ho, wo, c)
            for two_pass in (False, True):
                assert voxelizer.frame_cluster_fits(h, w, two_pass, c) == bool(
                    lib.evfly_hist_frame_cluster_fits(h, w, int(two_pass), c))
        for two_pass in (False, True):
            assert voxelizer.k1_route(h, w, two_pass).cluster == \
                lib.evfly_hist_frame_route(h, w, int(two_pass))
            assert voxelizer.band_route_cells(h, w, two_pass) == \
                lib.evfly_hist_band_cells(h, w, int(two_pass))


@pytest.mark.gpu
def test_k1_cluster_takes_more_windows_than_grid_y_on_gpu(cuda_device):
    H, W = 64, 86
    x, y, p = (torch.from_numpy(a).to(cuda_device) for a in _events(33, 70000, 16, H, W))
    got = voxelizer.hist_frame_cluster(x, y, p, H, W)
    assert torch.equal(got, voxelizer.hist_frame_plain(x, y, p, H, W))


@pytest.mark.gpu
@pytest.mark.parametrize("B,N", [(256, 5000), (2, 80), (2, 20000), (2, 32767), (2, 40000),
                                 (2, 100000)])
def test_k2_cluster_kernel_matches_plain_on_gpu(cuda_device, B, N):
    x, y, p = (torch.from_numpy(a).to(cuda_device) for a in _events(19 + N, B, N, 260, 346))
    if N == 32767:  # int16 counts at +-32,000, on the last row of band 0
        x[:, :32000], y[:, :32000] = 200.5, 129.5
        p[0, :32000], p[1, :32000] = 1, -1
    if N == 40000:  # a count past int16
        x[0, :33000], y[0, :33000], p[0, :33000] = 100.5, 130.5, 1
    if N == 100000:  # 400 counts past the dense table, across a band edge
        x[:, :50000] = 150.0 + x[:, :50000] * (20.0 / 346)
        y[:, :50000] = 25.0 + y[:, :50000] * (20.0 / 260)
    assert voxelizer.scaled_route(N, 260, 346) == "cluster"
    before = voxelizer.hist_scaled.launches
    out, q = voxelizer.hist_scaled(x, y, p, 260, 346)
    assert voxelizer.hist_scaled.launches == before + 1
    ref, qref = voxelizer.hist_scaled_plain(x, y, p, 260, 346)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
    assert torch.equal(q, qref)
    for cluster in (4, 8):
        got, gq = voxelizer._scaled_cluster_launch(x, y, p, 260, 346, 0.2, 0.97, 18, cluster)
        torch.testing.assert_close(got, ref, atol=2e-5, rtol=0)
        assert torch.equal(gq, qref)


@pytest.mark.gpu
@pytest.mark.parametrize("resize", [None, (60, 90)], ids=["frame", "resized"])
@pytest.mark.parametrize("kind", ["hot", "deep", "offset"])
def test_scale_counts_kernels_match_plain_on_gpu(cuda_device, kind, resize):
    """Both scale_counts kernels on every cluster size against their plain
    versions: K1's counts of 2 x 200,000 events with 33,000 on one pixel;
    counts of +-60..140 on every cell (v_k past the dense table); and a
    count frame starting 4 bytes past 16-byte alignment (a copy)."""
    H, W = 260, 346
    if kind == "deep":
        rng = np.random.default_rng(3)
        counts = torch.tensor(rng.integers(60, 140, (2, H, W)) * rng.choice([-1, 1], (2, H, W)),
                              dtype=torch.float32, device=cuda_device)
    else:
        x, y, p = (torch.from_numpy(a).to(cuda_device) for a in _events(40, 2, 200000, H, W))
        x[1, :33000], y[1, :33000], p[1, :33000] = 100.5, 130.5, 1
        counts = voxelizer.hist_frame_plain(x, y, p, H, W, 1.0, 1.0)
        if kind == "offset":
            counts = torch.cat([torch.zeros(1, device=cuda_device), counts.ravel()])[1:]
            counts = counts.reshape(2, H, W)
    name = "scale_counts" if resize is None else "scale_counts_resized"
    extra = () if resize is None else resize
    plain = voxelizer.scale_counts_plain if resize is None else voxelizer.scale_counts_resized_plain
    ref, qref = plain(counts, *extra)
    kernel = getattr(voxelizer, name)
    before = kernel.launches
    out, q = kernel(counts, *extra)
    assert kernel.launches == before + 1
    atol = 2e-5 if resize is None else 3e-5
    torch.testing.assert_close(out, ref, atol=atol, rtol=0)
    assert torch.equal(q, qref)
    for cluster in (1, 4, 8, 16):
        got, gq = voxelizer._scale_launch(name, counts, 0.2, 0.97, 18,
                                          None if resize is None else (*resize, False), cluster)
        torch.testing.assert_close(got, ref, atol=atol, rtol=0)
        assert torch.equal(gq, qref)
