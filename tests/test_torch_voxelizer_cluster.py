"""K1's and K3's cluster kernels: their rules, mirrored on the CPU.

The kernels (``csrc/voxelizer.cu``, ``hist_frame_cluster_kernel`` and
``hist_scaled_resized_cluster_kernel``) run one thread-block cluster of C
CTAs per window, the window's int32 count frame cut into C bands of
``band_rows(H, C)`` rows.  What decides their results besides the
arithmetic of the plain versions is bookkeeping: which CTA owns a cell,
which output rows a CTA writes and which neighbour row it reads, how the
events are sliced, where K1's band lies in shared memory against its
16-byte output groups, and how the count-of-counts tables of the bands
merge.  These tests state each rule in numpy, as the kernel computes it,
and hold it exhaustively against what it must equal: ``_taps`` (the resize
taps), the dense count-of-counts of ``hist_scaled_resized_plain``'s counts
and its quantile (exact), and the JAX package's functions (K1 exact, K3
within 3e-5, the JAX package's bound, tests/test_fused_voxelizer.py:68).
The kernels themselves run only on the card: the ``gpu`` tests below, and
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from evfly_tpu.ops import voxelizer as jvox
from evfly_tpu_torch.ops import voxelizer
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


# ----------------------------------------------------------------- fit rules


def test_cluster_caps_and_routes_by_shape():
    """K3 takes up to its cap: the band, the taps, a row and the window's
    list of the cells with |count| >= 64 (at most N / 64) in 231,424 bytes,
    763,135 events at 260x346 -> 60x90 on 2 CTAs (2,910,975 on 8), with
    int16 counts up to 32,767 events; K2's cap is unchanged; K1 takes its
    cluster kernel where the band fits."""
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
    # K2 keeps its packed kernel and its cap
    assert voxelizer.scaled_route(5000, H, W) == "packed"
    assert voxelizer.scaled_route(20000, H, W) == "k1"
    assert voxelizer.scaled_route(32767, 64, 86) == "packed"
    assert voxelizer.scaled_route(32768, 64, 86) == "k1"
    # one row too wide for a band and its copy: K1's counts
    assert voxelizer.resized_cluster_cap(1, 60000, 1, 10) == -1
    assert voxelizer.scaled_route(10, 1, 60000, (1, 10)) == "k1"
    # where the int32 band leaves less than 32,767 events, the packed one's
    # cap, at most 32,767
    assert voxelizer.resized_cluster_cap(260, 346, 60, 90, 1) == 32767
    assert voxelizer.resized_cluster_cap(420, 346, 60, 90, 2) == 32767
    assert voxelizer.k1_route(H, W, False) == voxelizer.k1_route(H, W, True) == "cluster"
    assert voxelizer.k1_route(64, 86, True) == "cluster"
    assert voxelizer.k1_route(4000, 4000, False) == "band"
    assert voxelizer.k1_route(480, 640, True) == "band"
    assert voxelizer.k1_route(480, 640, False) == "cluster"


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


# ------------------------------------------------------- the launchers on the CPU


def test_cluster_launchers_refuse_cpu_tensors():
    x, y, p = (torch.from_numpy(a) for a in _events(3, 1, 50, 16, 20))
    with pytest.raises(ValueError, match="unsupported device"):
        voxelizer._frame_cluster_launch(x, y, p, 16, 20, 0.2, 0.2, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        voxelizer._resized_cluster_launch(x, y, p, 16, 20, 8, 10, 0.2, 0.97, 18, False, 8)


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
            for ho, wo in ((60, 90), (h, w)):
                assert voxelizer.resized_cluster_cap(h, w, ho, wo, c) == \
                    lib.evfly_hist_resized_cluster_cap(h, w, ho, wo, c)
            for two_pass in (False, True):
                assert voxelizer.frame_cluster_fits(h, w, two_pass, c) == bool(
                    lib.evfly_hist_frame_cluster_fits(h, w, int(two_pass), c))


@pytest.mark.gpu
def test_k1_cluster_takes_more_windows_than_grid_y_on_gpu(cuda_device):
    H, W = 64, 86
    x, y, p = (torch.from_numpy(a).to(cuda_device) for a in _events(33, 70000, 16, H, W))
    got = voxelizer.hist_frame_cluster(x, y, p, H, W)
    assert torch.equal(got, voxelizer.hist_frame_plain(x, y, p, H, W))

