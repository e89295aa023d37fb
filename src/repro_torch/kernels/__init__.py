"""Hand-written CUDA kernels of the port, one subpackage each.

Each subpackage has:
  <name>.py — the ctypes binding of ``csrc/<name>.cu`` (built by ``_build``)
  ops.py    — the public wrapper: the kernel for CUDA tensors, the plain
              version for CPU tensors, and a ``launches`` counter
  ref.py    — the plain PyTorch version of the same function

  histogram            — phase A's per-slot K^(i) (paper §4.1)
  sketch_hist          — phase A's count-min grid under stats="sketch"
                         (both: csrc/pair_count.cuh, and pair_split.py for
                         the instance a weights dtype takes and the row
                         split the kernels follow)
  fused_shuffle_reduce — phase B's gather + sorted segment-sum (§4.4) and
                         each segment's pair count
  segment_reduce       — sorted segment-sum without the gather (its own
                         entry point; no engine path launches it)
                         (both: csrc/segment_tiles.cuh, the tiles and the
                         order in which a segment's rows are added)
  coded_shuffle        — XOR of word slabs: the coded shuffle's packet
                         encode (one instance: slab ^ its swap, masked)
                         and decode (the flat instance;
                         shuffle_replication=2)
  wave_timer           — %globaltimer stamps (read_ticks) and copy + stamp
                         (stamp_through): the measured executor's wave
                         clocks on the sharded backend; ref.py also holds
                         the tick word format, calibration.py the tick unit
  flash_attention      — causal GQA online-softmax attention: every prefill
                         of the serving engine with attn_impl="pallas";
                         ops.py also holds the decode path (plain ops)
  moe_dispatch         — stable counting-sort ranks and counts under a
                         bucket scatter (its own entry point; no engine or
                         model path launches it); span_split.py mirrors how
                         it loads a tile
"""
