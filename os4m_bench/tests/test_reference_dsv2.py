"""The plain DeepSeek-V2 reference against the port, on the CPU at the
port's SMOKE widths in float32: the port's prefill, then decode steps
through its cache, give the reference's full forward pass; the reference
computed in blocks is the reference computed whole; and two faults of the
architecture are caught outside the tolerance."""

import pytest
import torch

from os4m_bench import dsv2_weights as W, reference_dsv2 as R, serve_harness
from os4m_bench.tests import dsv2_small

# Float32 on both sides, the same routing: the logits agree to rounding
# (1e-6 of the largest logit measured); 1e-4 leaves room for the order of
# summation and stays far under a fault of the architecture (>= 1e-2).
TOL = 1e-4
DECODE_STEPS = 16


def weights(config, fp8=False):
    return lambda specs: W.reference_tensors(specs, dsv2_small.SEED, "cpu", fp8)


def tokens(length: int) -> torch.Tensor:
    return torch.randint(0, dsv2_small.SMOKE["vocab_size"], (length,),
                         generator=torch.Generator().manual_seed(length))


def port_logits(config, seq: torch.Tensor, prompt: int):
    """The port's logits of ``seq``: a prefill of ``prompt`` tokens, then one
    decode step a token through the cache; and the MoE's dropped tokens."""
    _, _, DecoderModel, _ = serve_harness.program()
    from repro_torch.models.model import forward, init_cache
    cfg = serve_harness.port_config(config)
    model = DecoderModel(cfg, device="cpu", ep_slots=config["port"]["ep_slots"])
    W.fill_program(model, config, dsv2_small.SEED)
    cache = init_cache(cfg, 1, seq.shape[0], dtype=torch.float32, device="cpu")
    with torch.inference_mode():
        out = forward(model, cfg, tokens=seq[None, :prompt], mode="prefill", cache=cache)
        logits, cache, drops = [out.logits[0]], out.cache, int(out.stats["overflow"])
        for i in range(prompt, seq.shape[0]):
            out = forward(model, cfg, tokens=seq[None, i:i + 1], mode="decode", cache=cache,
                          cache_pos=torch.tensor([i]))
            logits.append(out.logits[0])
            cache, drops = out.cache, drops + int(out.stats["overflow"])
    return torch.cat(logits), drops


def gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def port_run():
    """``(config, sequence, port logits)``; a prompt of 13 tokens (no
    multiple of the 4 slots: the broadcast MoE body) and 16 decode steps."""
    config = dsv2_small.config(ep_slots=4)
    seq = tokens(13 + DECODE_STEPS)
    logits, drops = port_logits(config, seq, 13)
    assert drops == 0
    return config, seq, logits


@pytest.mark.parametrize("prompt", [12, 13])
@pytest.mark.parametrize("ep_slots", [4, 8])
def test_port_prefill_and_decode_match_the_reference(prompt, ep_slots):
    config = dsv2_small.config(ep_slots=ep_slots)
    seq = tokens(prompt + DECODE_STEPS)
    port, drops = port_logits(config, seq, prompt)
    ref = R.logits(config, weights(config), [seq], [0], "cpu")[0]
    assert drops == 0 and port.shape == ref.shape
    assert gap(port, ref) < TOL


def test_blocks_equal_the_whole(port_run):
    config, seq, _ = port_run
    whole = R.logits(config, weights(config), [seq], [0], "cpu", row_block=10 ** 6,
                     token_block=10 ** 6)[0]
    blocks = R.logits(config, weights(config), [seq], [0], "cpu", row_block=3, token_block=5)[0]
    assert gap(blocks, whole) < TOL


def test_logits_from_a_start_are_the_tail(port_run):
    config, seq, _ = port_run
    both = R.logits(config, weights(config), [seq, seq[:20]], [0, 7], "cpu")
    assert gap(both[1], both[0][7:20]) < TOL


def no_shared_experts(monkeypatch):
    """The MoE without its shared experts."""
    real_moe = R.moe

    def moe(config, w, p, x):
        w = dict(w)
        for n in ("gate", "up", "down"):
            w[p + f"mlp.shared_experts.{n}_proj.weight"] = torch.zeros_like(
                w[p + f"mlp.shared_experts.{n}_proj.weight"])
        return real_moe(config, w, p, x)
    monkeypatch.setattr(R, "moe", moe)


def half_rope(monkeypatch):
    """RoPE that rotates only the first half of the dims."""
    real = R.rope

    def rope(x, theta):
        out = real(x, theta)
        half = x.shape[-1] // 2
        return torch.cat([out[..., :half], x[..., half:]], dim=-1)
    monkeypatch.setattr(R, "rope", rope)


@pytest.mark.parametrize("fault", [no_shared_experts, half_rope])
def test_faults_fall_outside_the_tolerance(port_run, fault, monkeypatch):
    config, seq, port = port_run
    fault(monkeypatch)
    ref = R.logits(config, weights(config), [seq], [0], "cpu")[0]
    assert gap(port, ref) > 100 * TOL
