"""K1's routes past an 8-CTA cluster: the route rule, the band route's
bookkeeping mirrored in numpy, and the plain versions against JAX.

K1 (``csrc/voxelizer.cu``) takes one of three routes by shape alone
(``voxelizer.k1_route``, the rule of the library's ``frame_cluster_route``):
its cluster kernel on 8 CTAs per window where their bands hold the frame, on
16 where those do, else the band route.  The band route is two kernels: a
partition pass, one block per chunk of 4,096 events of a window, that bins
each event once and writes its key (2 * cell + [sign < 0]) into the window's
run of key scratch sorted by band within its chunk (a counting sort in
shared memory: each key's rank from a shared-memory atomic, the bands'
offsets from a block scan), with the offsets of the bands' runs in a table;
then one block per (window, band) that reads only its band's keys.  What
decides its result besides the plain version's arithmetic is that
bookkeeping: the chunks of each window (``band_route_layout``, the wrapper's
own function), the search from a chunk to its window, the block scan, the
table and the keys' places.  These tests state each in numpy as the kernels
compute it and hold the resulting frames against the plain versions bit for
bit, counting every event read and every key written and read.  The plain
versions are held against the JAX package's functions (Pallas K1 in
interpret mode) at 640x480 and 1280x720 with two thresholds, exactly.  The
kernels themselves run only on the card: the ``gpu`` tests in
``tests/test_torch_voxelizer.py`` and ``tests/test_torch_events.py``, and
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from evfly_tpu.ops import voxelizer as jvox
from evfly_tpu_torch.ops import voxelizer
from evfly_tpu_torch.ops.voxelizer import K1Route

CHUNK = 4096        # the kernel's kChunk
THREADS = 512       # its kPartThreads: the block scan's threads
MAX_BANDS = 8192    # kMaxBands


# ------------------------------------------------------------ the route rule

@pytest.mark.parametrize("H,W,two_pass,route", [
    (260, 346, False, ("cluster", 8)), (260, 346, True, ("cluster", 8)),
    (480, 640, False, ("cluster", 8)), (480, 640, True, ("cluster", 16)),
    (720, 1280, False, ("cluster", 16)), (720, 1280, True, ("band", 0)),
    (1080, 1920, False, ("band", 0)), (1080, 1920, True, ("band", 0)),
])
def test_k1_route_by_shape(H, W, two_pass, route):
    """The frames of DAVIS346, 640x480 and 1280x720 (Prophesee) and 1080p
    sensors: 8 CTAs where their bands fit, else 16, else the band route."""
    got = voxelizer.k1_route(H, W, two_pass)
    assert isinstance(got, K1Route) and got == route
    assert str(got) == ("band" if route[0] == "band" else f"cluster{route[1]}")


def _band_ints(H, W, C):
    # a CTA's band array of the cluster kernel: ceil(H / C) rows, 3 words
    # of lead, whole int4s (csrc/voxelizer.cu's band_ints)
    return (-(-H // C) * W + 3 + 3) // 4 * 4


@pytest.mark.parametrize("H", [1, 7, 64, 260, 480, 481, 720, 1080, 2000])
@pytest.mark.parametrize("W", [1, 86, 346, 640, 1280, 1920])
def test_k1_route_is_the_library_rule(H, W):
    """k1_route against the library's rule restated from its byte counts:
    the least of 8 and 16 CTAs whose bands (two arrays with two thresholds)
    fit 231,424 bytes of a block's shared memory, else the band route; and
    the band route has a band wherever the frame is below 2^30 cells."""
    for two_pass in (False, True):
        arrays = 2 if two_pass else 1
        fits = [C for C in (8, 16) if arrays * _band_ints(H, W, C) * 4 <= 232448 - 1024]
        want = ("cluster", fits[0]) if fits else ("band", 0)
        assert voxelizer.k1_route(H, W, two_pass) == want
        assert voxelizer.band_route_cells(H, W, two_pass) > 0


def test_k1_route_at_the_16_cta_edge():
    """One threshold at 1280x720 on 16 CTAs: 45 rows x 1280 cells + 3 of
    lead, 230,416 bytes of the 231,424 a CTA may take; a 736-row frame
    passes them."""
    assert _band_ints(720, 1280, 16) * 4 == 230416
    assert voxelizer.frame_cluster_fits(720, 1280, False, 16)
    assert not voxelizer.frame_cluster_fits(720, 1280, False, 8)
    assert voxelizer.k1_route(736, 1280, False) == ("band", 0)
    # two thresholds at 640x480: 30 rows of two arrays, 153,632 bytes
    assert voxelizer.frame_cluster_fits(480, 640, True, 16)
    assert 2 * _band_ints(480, 640, 16) * 4 == 153632


# ------------------------------------------------------- the band geometry

@pytest.mark.parametrize("H,W", [(1, 1), (30, 40), (64, 86), (260, 346), (480, 640),
                                 (720, 1280), (1080, 1920), (4000, 4000), (9000, 9000)])
@pytest.mark.parametrize("two_pass", [False, True])
def test_band_route_cells(H, W, two_pass):
    """A band is 8,192 int32 counts of flat cells (4,096 cells with two
    thresholds), a multiple of 4 and at most the frame rounded up to 4,
    wider only where the frame would need more than 8,192 bands, and its
    counts fit a block's shared memory; the bands cover the frame."""
    arrays = 2 if two_pass else 1
    cells = voxelizer.band_route_cells(H, W, two_pass)
    HW = H * W
    assert cells > 0 and cells % 4 == 0
    bands = voxelizer.band_count(H, W, cells)
    assert bands <= MAX_BANDS and (bands - 1) * cells < HW <= bands * cells
    assert arrays * cells * 4 <= 232448 - 1024
    if -(-HW // MAX_BANDS) <= 8192 // arrays:
        assert cells == min(8192 // arrays, (HW + 3) // 4 * 4)
    # the partition pass's shared memory: the bands' counts and a chunk of keys
    assert ((bands + 1 + 3) // 4 * 4 + CHUNK) * 4 <= 232448 - 1024


def test_band_route_cells_at_the_sensors():
    assert voxelizer.band_route_cells(720, 1280, True) == 4096
    assert voxelizer.band_count(720, 1280, 4096) == 225
    assert voxelizer.band_route_cells(480, 640, True) == 4096
    assert voxelizer.band_count(480, 640, 4096) == 75
    assert voxelizer.band_route_cells(1080, 1920, False) == 8192
    assert voxelizer.band_count(1080, 1920, 8192) == 254
    # past 2^30 cells a key (2 * cell + sign) passes int32: no band route
    assert voxelizer.band_route_cells(2 ** 15, 2 ** 15, False) == -1


# --------------------------------------------- the band route's bookkeeping

def block_exclusive_scan(a):
    """numpy mirror of the kernel's block_exclusive_scan over n counts with
    THREADS threads: thread t sums its run [t * per, (t + 1) * per) of a,
    the runs' sums are scanned across warps and threads, and each thread
    writes its run's exclusive prefixes; a[n] gets the total, from the last
    thread."""
    n = len(a)
    per = -(-n // THREADS)
    out = np.zeros(n + 1, np.int64)
    sums = np.array([a[min(n, t * per):min(n, min(n, t * per) + per)].sum()
                     for t in range(THREADS)], np.int64)
    incl = np.zeros(THREADS, np.int64)
    for w in range(THREADS // 32):  # warp_inclusive_scan in each warp
        incl[32 * w:32 * w + 32] = np.cumsum(sums[32 * w:32 * w + 32])
    warp_tot = incl[31::32]
    warp_excl = np.cumsum(warp_tot) - warp_tot  # warp 0's scan of the warps' totals
    written = np.zeros(n + 1, np.int64)
    for t in range(THREADS):
        run = warp_excl[t // 32] + incl[t] - sums[t]
        i0 = min(n, t * per)
        for i in range(i0, min(n, i0 + per)):
            out[i] = run
            written[i] += 1
            run += a[i]
        if t == THREADS - 1:
            out[n] = run
            written[n] += 1
    assert (written == 1).all()
    return out


@pytest.mark.parametrize("n", [1, 2, 75, 225, 511, 512, 513, 1954, 3907, 8192])
def test_block_exclusive_scan(n):
    a = np.random.default_rng(n).integers(0, 50, n)
    a[::7] = 0
    np.testing.assert_array_equal(block_exclusive_scan(a),
                                  np.concatenate([[0], np.cumsum(a)]))


def chunk_window(chunk_end, c):
    """The kernel's chunk_window: the least b with chunk_end[b] > c, by
    binary search over [0, T - 1]."""
    lo, hi = 0, len(chunk_end) - 1
    while lo < hi:
        mid = (lo + hi) >> 1
        if chunk_end[mid] > c:
            hi = mid
        else:
            lo = mid + 1
    return lo


def test_band_route_layout_and_chunk_search():
    """The wrapper's layout: every window's chunks of 4,096 events in window
    order (empty windows none), its keys at the running total of the
    lengths before it; the search finds each chunk's window."""
    begin = torch.tensor([0, 100, 9000, 700, 30000, 50, 0, 5], dtype=torch.int64)
    end = torch.tensor([1000, 100, 30000, 29000, 30000, 10, 30000, 4101], dtype=torch.int64)
    chunk_end, key_base, n_keys, chunks = voxelizer.band_route_layout(begin, end)
    lengths = (end - begin).clamp_min(0).numpy()
    per = -(-lengths // CHUNK)
    np.testing.assert_array_equal(chunk_end.numpy(), np.cumsum(per))
    np.testing.assert_array_equal(key_base.numpy(), np.cumsum(lengths) - lengths)
    assert (n_keys, chunks) == (int(lengths.sum()), int(per.sum()))
    assert chunk_end.dtype == key_base.dtype == torch.int64
    owners = [chunk_window(chunk_end.numpy(), c) for c in range(chunks)]
    np.testing.assert_array_equal(owners, np.repeat(np.arange(len(begin)), per))
    empty = torch.zeros(0, dtype=torch.int64)
    assert voxelizer.band_route_layout(empty, empty)[2:] == (0, 0)


def band_route_model(x, y, p, begin, end, H, W, thresholds, batch_n=None):
    """numpy mirror of the band route over T windows: the partition pass
    (chunks by ``band_route_layout``, or ceil(N / 4096) per window of a (B,
    N) batch with ``batch_n`` = N), then the band pass, with the kernels'
    index arithmetic.  Returns (frames, event reads, key writes, key reads):
    the frames as the kernels write them, how often each event was read,
    and how often each slot of the key scratch was written and read."""
    two_pass = thresholds[0] != thresholds[1]
    band_cells = voxelizer.band_route_cells(H, W, two_pass)
    bands = voxelizer.band_count(H, W, band_cells)
    T = len(begin)
    if batch_n is None:
        chunk_end, key_base, n_keys, chunks = voxelizer.band_route_layout(begin, end)
        chunk_end, key_base = chunk_end.numpy(), key_base.numpy()
        starts, lengths = begin.numpy(), (end - begin).clamp_min(0).numpy()
    else:
        per = -(-batch_n // CHUNK)
        chunk_end = per * np.arange(1, T + 1)
        key_base = batch_n * np.arange(T)
        starts, lengths = key_base, np.full(T, batch_n)
        n_keys, chunks = T * batch_n, T * per
    xi, yi, sign = (a.numpy() for a in voxelizer.bin_events(x, y, p, H, W))
    keys = np.full(n_keys, -1, np.int64)
    table = np.zeros((chunks, bands + 1), np.int64)
    event_reads = np.zeros(len(x), np.int64)
    key_writes = np.zeros(n_keys, np.int64)

    # pass 1: one block per chunk
    for c in range(chunks):
        b = chunk_window(chunk_end, c)
        c0 = chunk_end[b - 1] if b else 0
        j0 = (c - c0) * CHUNK
        n = min(CHUNK, lengths[b] - j0)
        assert n >= 1
        ev = starts[b] + j0 + np.arange(n)
        event_reads[ev] += 1
        kept = sign[ev] != 0
        idx = (yi[ev] * W + xi[ev])[kept]
        key = 2 * idx + (sign[ev][kept] < 0)
        band = idx // band_cells
        counts = np.bincount(band, minlength=bands)
        row = block_exclusive_scan(counts)
        table[c] = row
        # each key at its band's offset plus its rank (any order in a band)
        rank = np.zeros(len(band), np.int64)
        seen = np.zeros(bands, np.int64)
        for i, k in enumerate(band):
            rank[i] = seen[k]
            seen[k] += 1
        slot = key_base[b] + j0 + row[band] + rank
        keys[slot] = key
        key_writes[slot] += 1

    # pass 2: one block per (window, band); warp w takes chunks c0 + w, ...
    key_reads = np.zeros(n_keys, np.int64)
    frames = np.zeros((T, H * W), np.float32)
    pos, neg = (np.float32(t) for t in thresholds)
    for b in range(T):
        c0, c1 = (chunk_end[b - 1] if b else 0), chunk_end[b]
        for k in range(bands):
            cell0 = k * band_cells
            cells = min(band_cells, H * W - cell0)
            pc = np.zeros(band_cells, np.int64)
            nc = np.zeros(band_cells, np.int64)
            for c in range(c0, c1):
                s0, s1 = table[c, k], table[c, k + 1]
                slots = key_base[b] + (c - c0) * CHUNK + np.arange(s0, s1)
                key_reads[slots] += 1
                kk = keys[slots]
                local = (kk >> 1) - cell0
                assert ((local >= 0) & (local < cells)).all()
                np.add.at(pc, local[kk & 1 == 0], 1)
                np.add.at(nc, local[kk & 1 == 1], 1)
            pcf, ncf = pc[:cells].astype(np.float32), nc[:cells].astype(np.float32)
            if not two_pass:
                frames[b, cell0:cell0 + cells] = pos * (pcf - ncf)
            elif batch_n is None:  # the window launch: fma(pos, pc, -(neg * nc))
                frames[b, cell0:cell0 + cells] = (
                    np.float64(pos) * pcf.astype(np.float64)
                    - (neg * ncf).astype(np.float64)).astype(np.float32)
            else:
                frames[b, cell0:cell0 + cells] = pos * pcf - neg * ncf
    return frames.reshape(T, H, W), event_reads, key_writes, key_reads


def _stream(seed, N, H, W):
    """N events with out-of-range coordinates, pol 0, a hot pixel and
    events on the right and bottom edges."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, W + 2, N).astype(np.float32)
    y = rng.uniform(-2, H + 2, N).astype(np.float32)
    p = rng.choice([-1, 0, 1], N).astype(np.int32)
    x[:5], y[:5] = W, H
    x[5:300], y[5:300], p[5:300] = 3.5, 2.5, 1
    return torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(p)


@pytest.mark.parametrize("H,W", [(64, 86), (480, 640), (720, 1280)])
@pytest.mark.parametrize("thresholds", [(0.2, 0.2), (0.2, 0.3)], ids=["one", "two"])
def test_band_route_model_over_windows_matches_plain(H, W, thresholds):
    """Overlapping, nested, empty and reversed windows, some of several
    chunks: every frame equal to hist_frame_windows_plain's bit for bit,
    each event read once per window holding it, every key written once and
    read once."""
    N = 12000
    x, y, p = _stream(H + W, N, H, W)
    begin = torch.tensor([0, 3000, 0, 5000, 11000, 7000, 2000, 11990], dtype=torch.int64)
    end = torch.tensor([4096, 8000, 12000, 5000, 12000, 6000, 2001, 12000], dtype=torch.int64)
    frames, reads, writes, key_reads = band_route_model(x, y, p, begin, end, H, W, thresholds)
    ref = voxelizer.hist_frame_windows_plain(x, y, p, begin, end, H, W, *thresholds)
    np.testing.assert_array_equal(frames, ref.numpy())
    holders = np.zeros(N, np.int64)
    for b0, b1 in zip(begin.tolist(), end.tolist()):
        holders[b0:max(b0, b1)] += 1
    np.testing.assert_array_equal(reads, holders)
    lengths = (end - begin).clamp_min(0)
    kept = np.concatenate([voxelizer.bin_events(x[b0:b1], y[b0:b1], p[b0:b1], H, W)[2].numpy()
                           for b0, b1 in zip(begin.tolist(), end.tolist()) if b1 > b0])
    # the kept keys of each chunk fill the start of its run, the rest unused
    assert writes.max() == 1 and writes.sum() == int((kept != 0).sum())
    assert len(writes) == int(lengths.sum())
    np.testing.assert_array_equal(key_reads, writes)


@pytest.mark.parametrize("H,W,B,N", [(64, 86, 3, 5000), (720, 1280, 2, 9000),
                                     (480, 640, 2, 0)])
@pytest.mark.parametrize("thresholds", [(0.2, 0.2), (0.2, 0.3)], ids=["one", "two"])
def test_band_route_model_over_a_batch_matches_plain(H, W, B, N, thresholds):
    """The (B, N) launch: each window ceil(N / 4096) chunks, its keys at b *
    N; equal to hist_frame_plain bit for bit (two thresholds rounded
    unfused, as event_histogram)."""
    xs, ys, ps = zip(*(_stream(10 * b + N, N, H, W) for b in range(B)))
    x, y, p = (torch.cat(a) for a in (xs, ys, ps))
    begin = torch.arange(B, dtype=torch.int64) * N
    frames, reads, writes, key_reads = band_route_model(x, y, p, begin, begin + N, H, W,
                                                        thresholds, batch_n=N)
    ref = voxelizer.hist_frame_plain(x.reshape(B, N), y.reshape(B, N), p.reshape(B, N), H, W,
                                     *thresholds)
    np.testing.assert_array_equal(frames, ref.numpy())
    assert (reads == 1).all() and writes.max(initial=0) <= 1
    np.testing.assert_array_equal(key_reads, writes)


# ------------------------------------------- the plain versions against JAX

def _edge_stream(seed, N, H, W):
    """A few thousand events with out-of-range and NaN coordinates, pol 0
    and events on the frame's right and bottom edges, with times."""
    x, y, p = (a.numpy().copy() for a in _stream(seed, N, H, W))
    x[300:310], y[310:320] = np.nan, -0.5
    rng = np.random.default_rng(seed + 1)
    t = rng.uniform(0.0, 1.0, N).astype(np.float32)
    t[:50] = 0.5  # on a window edge
    return t, x, y, p


@pytest.mark.parametrize("H,W", [(480, 640), (720, 1280)])
def test_event_histogram_two_thresholds_matches_jax(H, W):
    _, x, y, p = _edge_stream(H, 3000, H, W)
    ref = np.asarray(jvox.event_histogram(jnp.asarray(x), jnp.asarray(y), jnp.asarray(p), H, W,
                                          0.2, 0.3))
    got = voxelizer.event_histogram(x, y, p, H, W, 0.2, 0.3, device="cpu")
    assert got.shape == (H, W) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref != 0).sum() > 1000


@pytest.mark.parametrize("H,W", [(480, 640), (720, 1280)])
def test_event_frames_from_windows_two_thresholds_matches_jax(H, W):
    t, x, y, p = _edge_stream(W, 3000, H, W)
    starts = np.array([0.0, 0.5, 0.25, 0.9, 0.7], np.float32)
    ends = np.array([0.5, 1.0, 0.75, 0.2, 0.7], np.float32)
    ref = np.asarray(jvox.event_frames_from_windows(
        *(jnp.asarray(a) for a in (t, x, y, p, starts, ends)), H, W, 0.2, 0.3))
    got = voxelizer.event_frames_from_windows(t, x, y, p, starts, ends, H, W, 0.2, 0.3,
                                              device="cpu")
    assert got.shape == (len(starts), H, W)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref[0] != 0).any() and not ref[3].any() and not ref[4].any()


# ------------------------------------------------ no route falls back

def test_k1_routes_refuse_cpu_tensors_and_frames_they_cannot_take():
    x, y, p = (t[None] for t in _stream(1, 50, 16, 20))
    with pytest.raises(ValueError, match="unsupported device"):
        voxelizer._frame_windows_launch(x[0], y[0], p[0], torch.tensor([0]),
                                        torch.tensor([50]), 16, 20, 0.2, 0.3,
                                        voxelizer.BAND_ROUTE)
    with pytest.raises(ValueError, match="no band"):
        voxelizer._band_scratch(torch.device("cpu"), 0, 0, 2 ** 15, 2 ** 15, False)
    # on the CPU every wrapper takes its plain version and counts nothing
    before = (voxelizer.hist_frame.launches, voxelizer.hist_frame_cluster.launches)
    a = voxelizer.hist_frame(x, y, p, 720, 1280, 0.2, 0.3)
    b = voxelizer.hist_frame_cluster(x, y, p, 720, 1280, 0.2, 0.2)
    assert (voxelizer.hist_frame.launches, voxelizer.hist_frame_cluster.launches) == before
    assert torch.equal(a, voxelizer.hist_frame_plain(x, y, p, 720, 1280, 0.2, 0.3))
    assert torch.equal(b, voxelizer.hist_frame_routed(x, y, p, 720, 1280))
