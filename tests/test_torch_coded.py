"""The coded shuffle and the quantized wire in the port against the reference.

Smallest to largest: the XOR word kernel's plain version against the
Pallas kernel (interpret mode); payload word packing against the
reference's words; the int8/fp8 encode and decode against the
reference's bits, edge values included; whole jobs with
``shuffle_replication=2`` and/or ``quantize_shuffle`` against the
reference ``MapReduceJob(..., backend="vmap")`` (plans equal, integer
outputs bit-equal, float outputs allclose, wire accounting equal); coded
equal to uncoded inside the port; coded plans replayed under reuse and
exchanged as JSON between the packages; the configuration errors. The
reference is imported inside the CPU tests only, so the ``gpu`` cases
also run where JAX is absent (``--noconftest -m gpu``).
"""

import json

import numpy as np
import pytest
import torch

from repro_torch.core import mapreduce as tmr
from repro_torch.core import schedule_cache as tsc
from repro_torch.kernels.coded_shuffle import ops as cs_ops
from repro_torch.kernels.coded_shuffle.ref import encode_packets_ref


def _identity(batch):
    return batch


# ---------------------------------------------------------------------------
# The XOR word kernel's plain version and the payload packing.
# ---------------------------------------------------------------------------


def _words(rng, shape, word):
    raw = rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
    return raw if word == "uint32" else raw.view(np.int32)


@pytest.mark.parametrize("n", [1, 7, 1000, 3000])
@pytest.mark.parametrize("w", [1, 5, 13])
@pytest.mark.parametrize("word", ["int32", "uint32"])
def test_xor_plain_matches_pallas(n, w, word):
    import jax.numpy as jnp

    from repro.kernels.coded_shuffle.coded_shuffle import xor_words_pallas

    rng = np.random.default_rng(n * 31 + w)
    a, b = _words(rng, (n, w), word), _words(rng, (n, w), word)
    got = cs_ops.xor_words(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(xor_words_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True))
    assert got.dtype == getattr(torch, word)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("m", [3, 4, 8])
@pytest.mark.parametrize("cap,w", [(1, 1), (5, 13), (37, 5)])
@pytest.mark.parametrize("word", ["int32", "uint32"])
def test_encode_plain_matches_reference_encode(m, cap, w, word):
    """The encode instance's plain version against the reference's encode of
    each sender: Pallas XOR of the slab and its (partner, dst) swap in
    interpret mode, then ``jnp.where(pair_ok, x, 0)``, bit for bit."""
    import jax.numpy as jnp

    from repro.kernels.coded_shuffle.coded_shuffle import xor_words_pallas

    rng = np.random.default_rng(m * 100 + cap + w)
    slab = _words(rng, (m, m, m, cap, w), word)
    got = cs_ops.encode_packets(torch.from_numpy(slab))
    assert got.dtype == getattr(torch, word) and got.shape == slab.shape
    dd, qq = np.arange(m)[:, None], np.arange(m)[None, :]
    for me in range(m):
        one = jnp.asarray(slab[me])
        x = xor_words_pallas(one.reshape(-1, w), jnp.swapaxes(one, 0, 1).reshape(-1, w),
                             interpret=True).reshape(m, m, cap, w)
        pair_ok = (dd != qq) & (dd != me) & (qq != me)
        want = np.asarray(jnp.where(jnp.asarray(pair_ok)[:, :, None, None], x, 0))
        np.testing.assert_array_equal(got[me].numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("m", [3, 8])
@pytest.mark.parametrize("rows", [1, 2])
def test_encode_of_a_sender_range_equals_those_rows_of_the_stacked_encode(m, rows):
    """One slot's share of the spill (the sharded backend's slab) encodes
    to its rows of the stacked encode, whichever senders it holds."""
    rng = np.random.default_rng(m + rows)
    slab = torch.from_numpy(_words(rng, (m, m, m, 6, 5), "int32"))
    whole = cs_ops.encode_packets(slab)
    for first in range(m - rows + 1):
        part = cs_ops.encode_packets(slab[first:first + rows].contiguous(), first_sender=first)
        assert torch.equal(part, whole[first:first + rows])
    with pytest.raises(ValueError, match="senders"):
        cs_ops.encode_packets(slab[:rows].contiguous(), first_sender=m - rows + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [3, 8])
@pytest.mark.parametrize("first", [0, 1, 7])
def test_encode_kernel_of_one_sender_matches_plain(m, first):
    """The encode instance on a (1, m, m, cap, W) slab of sender ``first``
    (the sharded backend's launch) against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    first = min(first, m - 1)
    rng = np.random.default_rng(m * 10 + first)
    slab = torch.from_numpy(_words(rng, (1, m, m, 79, 13), "int32")).cuda()
    got = cs_ops.encode_packets(slab, first_sender=first)
    torch.cuda.synchronize()
    assert torch.equal(got, encode_packets_ref(slab, first))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [3, 8])
@pytest.mark.parametrize("cap,w", [(1, 1), (78, 13), (79, 13), (256, 4), (257, 4),
                                   (4096, 5)])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_encode_kernel_matches_plain(m, cap, w, offset):
    """At blocks around one CTA's tile (256 int4 = 1024 words: 78 x 13 and
    79 x 13 straddle it, 256 x 4 fills it) and slab starts 0, 4, 8 and 12
    bytes past a 16-byte boundary (the vector path and the word path)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(m + cap + w + offset)
    size = m ** 3 * cap * w
    raw = rng.integers(0, 2 ** 32, size + offset, dtype=np.uint32).view(np.int32)
    buf = torch.from_numpy(raw).cuda()
    slab = buf[offset:].view(m, m, m, cap, w)
    before = dict(cs_ops.launches_by_design)
    got = cs_ops.encode_packets(slab)
    torch.cuda.synchronize()
    assert cs_ops.launches_by_design["encode"] == before["encode"] + 1
    assert cs_ops.launches_by_design["flat"] == before["flat"]
    assert torch.equal(got, encode_packets_ref(slab))
    assert torch.equal(cs_ops.encode_packets(slab.view(torch.uint32)).view(torch.int32), got)


_LANE_NP = {1: np.uint8, 2: np.int16, 4: np.int32}


def _to_torch(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A numpy array of any payload dtype (ml_dtypes included), bit for bit."""
    return torch.from_numpy(arr.view(_LANE_NP[arr.dtype.itemsize]).copy()).view(dtype)


@pytest.mark.parametrize("name", ["float32", "bfloat16", "int8", "float8_e4m3fn"])
@pytest.mark.parametrize("v", [1, 5, 8, 11])
def test_pack_matches_reference_words(name, v):
    import jax.numpy as jnp

    from repro.kernels.coded_shuffle import ops as ref_ops

    rng = np.random.default_rng(v)
    if name == "int8":
        x = jnp.asarray(rng.integers(-128, 128, (37, v)), jnp.int8)
    else:
        x = jnp.asarray(rng.standard_normal((37, v)) * 3, jnp.float32).astype(
            getattr(jnp, name))
    raw = np.asarray(x)
    dtype = getattr(torch, name)
    words = cs_ops.pack_payload_words(_to_torch(raw, dtype))
    want = np.asarray(ref_ops.pack_payload_words(x))
    assert words.dtype == torch.int32
    assert words.shape == (37, cs_ops.packed_width(v, dtype)) == want.shape
    np.testing.assert_array_equal(words.numpy(), want)
    back = cs_ops.unpack_payload_words(torch.from_numpy(want.copy()), dtype, v)
    np.testing.assert_array_equal(back.contiguous().view(torch.uint8).numpy(),
                                  raw.view(np.uint8))
    with pytest.raises(ValueError):
        cs_ops.unpack_payload_words(words, dtype, v + 4)


# ---------------------------------------------------------------------------
# Quantized wire: encode / decode bits.
# ---------------------------------------------------------------------------

INF, NAN = float("inf"), float("nan")
# e4m3fn: 448 is the largest finite value; 464 is the tie with 480, which
# rounds to 448 (even); everything above, and +-inf, is NaN in the
# reference. Ties between neighbours (1.0625, 1.1875, 17, 19, 3 * 2^-10)
# and a subnormal tie (2^-10) check round-half-to-even.
FP8_EDGES = [0.0, -0.0, 1.0, 1.0625, 1.1875, 17.0, 19.0, -19.0, 2.0 ** -10,
             3 * 2.0 ** -10, 240.0, 440.0, 448.0, 449.0, 456.0, 464.0, -464.0,
             465.0, -465.0, 480.0, -480.0, 1e6, -1e6, INF, -INF, NAN]


def test_fp8_encode_decode_match_reference_bits():
    import jax.numpy as jnp

    from repro.core import mapreduce as ref_mr

    x = np.asarray(FP8_EDGES, np.float32).reshape(-1, 2)
    want_q = np.asarray(ref_mr._quantize_encode(jnp.asarray(x), None, "fp8")).view(np.uint8)
    got_q = tmr._quantize_encode(torch.from_numpy(x), None, "fp8")
    assert got_q.dtype == tmr._wire_payload_dtype("fp8", torch.float32)
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    # A plain cast saturates where the reference gives NaN: the case the
    # port's explicit step exists for.
    plain = torch.from_numpy(x).to(torch.float8_e4m3fn).view(torch.uint8).numpy()
    assert (plain != want_q).any()
    want_d = np.asarray(ref_mr._quantize_decode(
        jnp.asarray(want_q.view(jnp.float8_e4m3fn)), None, jnp.float32, "fp8"))
    got_d = tmr._quantize_decode(got_q, None, torch.float32, "fp8").numpy()
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(np.signbit(got_d), np.signbit(want_d))


@pytest.mark.parametrize("top", [127.0, 100.0, 0.0])
def test_int8_scale_encode_decode_match_reference_bits(top):
    """One scale over every slot's valid records; round half to even."""
    import jax
    import jax.numpy as jnp

    from repro.core import mapreduce as ref_mr

    vals = np.array([[[0.5, 1.5], [2.5, -0.5], [-1.5, 63.5], [-63.5, 3.7]],
                     [[1e6, -0.0], [-2.5, 0.25], [top, 126.5], [-top, 1.0]]], np.float32)
    valid = np.array([[True, True, True, True], [False, True, True, True]])
    if top == 0.0:
        vals = np.zeros_like(vals)   # the 1e-12 floor of the scale
    rj = jax.vmap(lambda v, ok: ref_mr._quantize_scale(v, ok, "int8"),
                  axis_name=ref_mr.AXIS)(jnp.asarray(vals), jnp.asarray(valid))
    want_q = np.asarray(jax.vmap(lambda v, s: ref_mr._quantize_encode(v, s, "int8"))(
        jnp.asarray(vals), rj))
    want_d = np.asarray(jax.vmap(
        lambda q, s: ref_mr._quantize_decode(q, s, jnp.float32, "int8"))(want_q, rj))
    scale = tmr._quantize_scale(torch.from_numpy(vals), torch.from_numpy(valid), "int8")
    assert np.float32(scale.item()) == np.asarray(rj)[0]
    got_q = tmr._quantize_encode(torch.from_numpy(vals), scale, "int8")
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    got_d = tmr._quantize_decode(got_q, scale, torch.float32, "int8").numpy()
    np.testing.assert_array_equal(got_d.view(np.uint32), want_d.view(np.uint32))


# ---------------------------------------------------------------------------
# Whole jobs against the reference.
# ---------------------------------------------------------------------------


def _batch(m, k, v, kind, seed=0):
    """Skewed int32 key hashes (INT32_MIN included), ~10% invalid pairs.

    ``int``: integers in [-3, 3] and one 127, so every int8 scale is 1 and
    every delivered value (fp8 rounds 127 to 128) stays an integer: sums
    are exact in any order. ``normal``: standard normals.
    """
    rng = np.random.default_rng(seed)
    base = (rng.zipf(1.3, size=(m, k)) % 997).astype(np.uint32)
    keys = (base * np.uint32(2654435761)).view(np.int32)
    keys[0, 0] = np.iinfo(np.int32).min
    valid = rng.random((m, k)) > 0.1
    valid[1, 3] = True
    vrng = np.random.default_rng(seed + 1)
    if kind == "int":
        values = vrng.integers(-3, 4, size=(m, k, v)).astype(np.float32)
        values[1, 3, 0] = 127.0
    else:
        values = vrng.standard_normal((m, k, v)).astype(np.float32)
    return keys, values, valid


def _spy_plans(job):
    """Record every plan ``job._plan`` returns (either package)."""
    plans = []
    plan = job._plan

    def spy(*args, **kwargs):
        plans.append(plan(*args, **kwargs))
        return plans[-1]

    job._plan = spy
    return plans


_REF_JOBS = {}


def _reference(batch, **cfg):
    """Reference run of ``batch``; one job (one compile) per configuration."""
    import jax.numpy as jnp

    from repro.core.mapreduce import MapReduceConfig, MapReduceJob

    key = tuple(sorted(cfg.items()))
    if key not in _REF_JOBS:
        job = MapReduceJob(_identity, MapReduceConfig(use_kernels=True, **cfg),
                           backend="vmap")
        _REF_JOBS[key] = (job, _spy_plans(job))
    job, plans = _REF_JOBS[key]
    return job.run(tuple(jnp.asarray(a) for a in batch)), plans[-1]


def _port(batch, device="cpu", **cfg):
    job = tmr.MapReduceJob(_identity, tmr.MapReduceConfig(**cfg), device=device)
    res = job.run(tuple(torch.from_numpy(a).to(device) for a in batch))
    return res, job


def _assert_plans_equal(ref, port):
    np.testing.assert_array_equal(port.schedule.assignment, ref.schedule.assignment)
    np.testing.assert_array_equal(port.waves.rank_of_cluster, ref.waves.rank_of_cluster)
    np.testing.assert_array_equal(port.waves.chunk_of_cluster, ref.waves.chunk_of_cluster)
    assert port.waves.replication == ref.waves.replication
    assert port.capacity == ref.capacity
    assert port.chunk_caps == ref.chunk_caps


WIRE_FIELDS = ("overflow", "shuffle_bytes", "shuffle_rows", "shuffle_pairs",
               "replication_bytes", "quantize_exact")


def _assert_results_match(ref, port, batch, n, kind):
    assert port.values.shape == ref.values.shape
    if kind == "int":
        np.testing.assert_array_equal(port.values, ref.values)
    else:
        # The reference's CPU segment sums add in another order: held to
        # 1e-5 of the sum of the cluster's magnitudes.
        keys, values, valid = batch
        cid = np.abs(keys.astype(np.int64)) % n
        mag = np.zeros((n, values.shape[-1]))
        np.add.at(mag, cid[valid], np.abs(values[valid]).astype(np.float64))
        if port.values.shape[-1] == 1:
            mag = mag[:, :1]
        assert (np.abs(port.values - ref.values)
                <= 1e-5 * np.abs(ref.values) + 1e-5 * mag).all()
    np.testing.assert_array_equal(port.counts, ref.counts)
    for field in WIRE_FIELDS:
        assert getattr(port, field) == getattr(ref, field), field


# (replication, quantize, pipelined, reduce_op, m): every wire format on
# both phase-B walks under sum, max and count on both walks, m = 4 and 5
# (r = 2 divides one and not the other).
JOB_CASES = [
    (r, q, p, "sum", 4 + (i % 2))
    for i, (r, q, p) in enumerate(
        [(1, "int8", True), (1, "int8", False), (1, "fp8", True), (1, "fp8", False),
         (2, None, True), (2, None, False), (2, "int8", True), (2, "int8", False),
         (2, "fp8", True), (2, "fp8", False)])
] + [
    (2, None, True, "max", 5), (2, "int8", False, "max", 4),
    (2, "fp8", True, "count", 4), (2, None, False, "count", 5),
]


@pytest.mark.parametrize("kind", ["int", "normal"])
@pytest.mark.parametrize("r,quantize,pipelined,reduce_op,m", JOB_CASES)
def test_job_matches_reference(r, quantize, pipelined, reduce_op, m, kind):
    n = 40
    batch = _batch(m, 512, 5, kind)
    cfg = dict(num_slots=m, num_clusters=n, pipeline_chunks=3, pipelined=pipelined,
               reduce_op=reduce_op, shuffle_replication=r, quantize_shuffle=quantize)
    ref, ref_plan = _reference(batch, **cfg)
    port, job = _port(batch, **cfg)
    _assert_plans_equal(ref_plan, job.last_plan)
    _assert_results_match(ref, port, batch, n, kind)
    if quantize == "int8" and kind == "int":
        assert port.quantize_exact is True       # scale 1: integers round-trip
    if quantize and kind == "normal":
        assert port.quantize_exact is False


def test_sketch_coded_job_matches_reference():
    batch = _batch(5, 512, 3, "int", seed=4)
    cfg = dict(num_slots=5, num_clusters=300, stats="sketch", sketch_width=64,
               shuffle_replication=2, quantize_shuffle="int8")
    ref, ref_plan = _reference(batch, **cfg)
    port, job = _port(batch, **cfg)
    _assert_plans_equal(ref_plan, job.last_plan)
    np.testing.assert_array_equal(job.last_plan.local_hist, ref_plan.local_hist)
    _assert_results_match(ref, port, batch, 300, "int")


# ---------------------------------------------------------------------------
# Inside the port: coded == uncoded, reuse, snapshots.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantize", [None, "int8", "fp8"])
@pytest.mark.parametrize("pipelined", [True, False])
@pytest.mark.parametrize("reduce_op", ["sum", "max", "count"])
def test_coded_equals_uncoded_in_port(quantize, pipelined, reduce_op):
    m = 5
    batch = _batch(m, 1024, 3, "normal", seed=2)
    cfg = dict(num_slots=m, num_clusters=64, pipelined=pipelined, reduce_op=reduce_op,
               quantize_shuffle=quantize)
    uncoded, _ = _port(batch, **cfg)
    coded, job = _port(batch, shuffle_replication=2, **cfg)
    assert job.last_plan.waves.replication == 2
    assert coded.overflow == uncoded.overflow == 0
    np.testing.assert_array_equal(coded.values, uncoded.values)
    np.testing.assert_array_equal(coded.counts, uncoded.counts)
    assert coded.shuffle_pairs == uncoded.shuffle_pairs
    assert coded.quantize_exact == uncoded.quantize_exact
    assert uncoded.replication_bytes == 0 < coded.replication_bytes


@pytest.mark.parametrize("m", [2, 3, 8])
def test_coded_equals_uncoded_across_slot_counts(m):
    """m = 2 has no multicast pair (all by replica); m = 8 is the paper's."""
    batch = _batch(m, 700, 4, "normal", seed=m)
    uncoded, _ = _port(batch, num_slots=m, num_clusters=50)
    coded, _ = _port(batch, num_slots=m, num_clusters=50, shuffle_replication=2)
    np.testing.assert_array_equal(coded.values, uncoded.values)
    np.testing.assert_array_equal(coded.counts, uncoded.counts)
    if m == 2:
        assert coded.shuffle_rows == 0
    else:
        assert coded.shuffle_bytes < uncoded.shuffle_bytes


def test_coded_overflow_matches_reference():
    """A forced capacity clamp drops pairs on the coded wire too, the same
    pairs as the reference's."""
    batch = _batch(4, 512, 2, "int", seed=9)
    cfg = dict(num_slots=4, num_clusters=40, capacity_send=8, shuffle_replication=2)
    ref, ref_plan = _reference(batch, **cfg)
    port, job = _port(batch, **cfg)
    assert port.overflow > 0
    _assert_plans_equal(ref_plan, job.last_plan)
    _assert_results_match(ref, port, batch, 40, "int")


def test_coded_plan_replays_under_reuse():
    m, n = 5, 48
    batches = [_batch(m, 512, 3, "int", seed=s) for s in (11, 11, 12)]
    job = tmr.MapReduceJob(_identity, tmr.MapReduceConfig(
        num_slots=m, num_clusters=n, shuffle_replication=2,
        reuse=tsc.ReusePolicy(max_drift=1.0)), device="cpu")
    plans = _spy_plans(job)
    for b, batch in enumerate(batches):
        res = job.run(tuple(torch.from_numpy(a) for a in batch))
        want, _ = _port(batch, num_slots=m, num_clusters=n)
        assert res.reused == (b > 0)
        assert job.last_plan.waves.replication == 2 and res.replication_bytes > 0
        np.testing.assert_array_equal(res.values, want.values)
        np.testing.assert_array_equal(res.counts, want.counts)
    assert len(plans) == 1


def test_coded_snapshot_loads_both_ways():
    """A coded plan's JSON, written by either package, replays coded in the
    other, to the other's outputs; a loaded coded plan runs coded even in
    a job configured uncoded (the wire format rides the plan)."""
    import jax.numpy as jnp

    from repro.core import schedule_cache as rsc
    from repro.core.mapreduce import MapReduceConfig, MapReduceJob

    m, n = 4, 40
    batch = _batch(m, 512, 3, "int", seed=6)
    cfg = dict(num_slots=m, num_clusters=n, shuffle_replication=2)
    ref = MapReduceJob(_identity, MapReduceConfig(use_kernels=True, reuse=rsc.ReusePolicy(),
                                                  **cfg), backend="vmap")
    ref_res = ref.run(tuple(jnp.asarray(a) for a in batch))
    ref_snap = json.loads(json.dumps(ref.schedule_cache.snapshot.to_json()))
    assert ref_snap["waves"]["replication"] == 2

    for replication in (2, 1):
        port = tmr.MapReduceJob(_identity, tmr.MapReduceConfig(
            num_slots=m, num_clusters=n, shuffle_replication=replication,
            reuse=tsc.ReusePolicy()), device="cpu")
        port.load_snapshot(ref_snap)
        res = port.run(tuple(torch.from_numpy(a) for a in batch))
        assert res.reused and port.last_plan.waves.replication == 2
        assert res.replication_bytes == ref_res.replication_bytes > 0
        np.testing.assert_array_equal(res.values, np.asarray(ref_res.values))
        np.testing.assert_array_equal(res.counts, np.asarray(ref_res.counts))
        if replication == 2:
            assert res.shuffle_bytes == ref_res.shuffle_bytes
            port_snap = json.loads(json.dumps(port.schedule_cache.snapshot.to_json()))

    ref2 = MapReduceJob(_identity, MapReduceConfig(use_kernels=True, reuse=rsc.ReusePolicy(),
                                                   **cfg), backend="vmap")
    ref2.load_snapshot(port_snap)
    back = ref2.run(tuple(jnp.asarray(a) for a in batch))
    assert back.reused
    np.testing.assert_array_equal(np.asarray(back.values), np.asarray(ref_res.values))


# ---------------------------------------------------------------------------
# Configuration errors.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [
    dict(shuffle_replication=3),
    dict(shuffle_replication=0),
    dict(num_slots=1, shuffle_replication=2),
    dict(shuffle_replication=2, checkpoint_waves=True),
    dict(quantize_shuffle="int4"),
    dict(quantize_shuffle="int8", checkpoint_waves=True),
])
def test_config_validation_raises_as_reference(kwargs):
    from repro.core import mapreduce as ref_mr

    base = dict(num_slots=4, num_clusters=8)
    base.update(kwargs)
    with pytest.raises(ValueError):
        ref_mr.MapReduceJob(_identity, ref_mr.MapReduceConfig(**base), backend="vmap")
    with pytest.raises(ValueError):
        tmr.MapReduceJob(_identity, tmr.MapReduceConfig(**base), device="cpu")


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("quantize", [None, "int8", "fp8"])
@pytest.mark.parametrize("pipelined", [True, False])
def test_cuda_coded_job_matches_cpu(quantize, pipelined):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    batch = _batch(5, 4096, 5, "normal", seed=13)
    cfg = dict(num_slots=5, num_clusters=64, shuffle_replication=2,
               quantize_shuffle=quantize, pipelined=pipelined)
    cpu, cpu_job = _port(batch, **cfg)
    x0 = cs_ops.launches
    gpu, gpu_job = _port(batch, device="cuda", **cfg)
    chunks = gpu_job.last_plan.waves.num_chunks if pipelined else 1
    assert cs_ops.launches == x0 + 2 * chunks
    _assert_plans_equal(cpu_job.last_plan, gpu_job.last_plan)
    # The card's fused reduce adds in another order than index_add_ on the
    # CPU; the wire, the counts and the accounting are exact.
    np.testing.assert_allclose(gpu.values, cpu.values, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(gpu.counts, cpu.counts)
    for field in WIRE_FIELDS:
        assert getattr(gpu, field) == getattr(cpu, field), field
    uncoded, _ = _port(batch, device="cuda", **{**cfg, "shuffle_replication": 1})
    np.testing.assert_array_equal(gpu.values, uncoded.values)
