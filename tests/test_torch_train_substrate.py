"""The port's training substrate against the reference's: optimizer and LR
schedule, checkpoint/restart, int8 compression with error feedback, OS4M
packing and the synthetic data pipeline.

The first four classes mirror the cases of ``tests/test_train_substrate.py``
on the port. ``TestParity`` puts the same numpy inputs through both
packages: ``lr_at`` equal over steps 0-200; ``adamw_step`` on a random
float32 tree over 5 steps with parameters and moments allclose at
``atol=rtol=1e-6`` (float32 moments) and bf16 moments equal bit for bit;
``compress_leaf``'s ``q`` and ``scale`` equal; ``pack_documents`` rows and
``PackingStats`` equal under os4m, lpt and hash; ``documents`` and
``token_batches`` equal; and the bf16 checkpoint round trip bit-exact.
"""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.data import packing
from repro_torch.data.synthetic import CorpusConfig, documents, token_batches
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compression as comp
from repro_torch.train.optim import OptConfig, adamw_step, init_opt, lr_at

ATOL = RTOL = 1e-6


def _grad_sq(params):
    """d/dp sum(p ** 2) = 2 p."""
    return {k: 2 * p.detach() for k, p in params.items()}


class TestOptim:
    def test_adamw_converges_quadratic(self):
        params = {"w": torch.tensor([5.0, -3.0])}
        ocfg = OptConfig(lr=0.2, weight_decay=0.0, warmup_steps=1,
                         decay_steps=10_000, clip_norm=0)
        opt = init_opt(params, ocfg)
        for _ in range(200):
            params, opt, _ = adamw_step(params, _grad_sq(params), opt, ocfg)
        assert float(params["w"].abs().max()) < 0.05

    def test_clip_bounds_update(self):
        params = {"w": torch.zeros(4)}
        ocfg = OptConfig(lr=1.0, clip_norm=1.0, weight_decay=0.0)
        opt = init_opt(params, ocfg)
        _, _, m = adamw_step(params, {"w": torch.full((4,), 1e6)}, opt, ocfg)
        assert float(m["grad_norm"]) > 1e5  # reported raw

    def test_lr_schedule_warmup_and_decay(self):
        ocfg = OptConfig(lr=1.0, warmup_steps=10, decay_steps=100, min_lr_ratio=0.1)
        assert float(lr_at(5, ocfg)) == pytest.approx(0.5)
        assert float(lr_at(10, ocfg)) == pytest.approx(1.0)
        assert float(lr_at(100, ocfg)) == pytest.approx(0.1)

    def test_bf16_moments(self):
        params = {"w": torch.ones(8)}
        opt = init_opt(params, OptConfig(moment_dtype="bfloat16"))
        assert opt["m"]["w"].dtype == torch.bfloat16

    def test_updates_in_place_on_parameters(self):
        """The step writes the model's own ``nn.Parameter``s and moments."""
        lin = torch.nn.Linear(3, 2)
        params = dict(lin.named_parameters())
        ocfg = OptConfig(lr=0.1, warmup_steps=1)
        opt = init_opt(params, ocfg)
        before = lin.weight.detach().clone()
        grads = {k: torch.ones_like(p) for k, p in params.items()}
        adamw_step(params, grads, opt, ocfg)
        assert not torch.equal(lin.weight.detach(), before)
        assert int(opt["step"]) == 1 and float(opt["m"]["weight"].abs().min()) > 0


class TestCheckpoint:
    def test_save_load_roundtrip(self, tmp_path):
        params = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4)}}
        opt = {"m": {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(4)}},
               "v": {"a": torch.ones(2, 3), "b": {"c": torch.ones(4)}},
               "step": torch.tensor(7, dtype=torch.int32)}
        ckpt.save(tmp_path, 7, params, opt, extra={"arch": "t"})
        state, extra = ckpt.load(tmp_path, 7)
        assert extra["arch"] == "t"
        np.testing.assert_allclose(state["params"]["a"].numpy(), params["a"].numpy())
        np.testing.assert_allclose(state["params"]["b"]["c"].numpy(), 1.0)
        assert int(state["opt"]["step"]) == 7
        assert state["opt"]["step"].dtype == torch.int32

    def test_keep_k_gc(self, tmp_path):
        params = {"a": torch.zeros(2)}
        for s in [1, 2, 3, 4, 5]:
            ckpt.save(tmp_path, s, params, keep=2)
        assert ckpt.latest_step(tmp_path) == 5
        steps = sorted(int(d.name.split("_")[1]) for d in tmp_path.iterdir())
        assert steps == [4, 5]

    def test_atomic_no_tmp_left(self, tmp_path):
        ckpt.save(tmp_path, 1, {"a": torch.zeros(2)})
        assert not list(tmp_path.glob("*.tmp"))
        assert ckpt.latest_step(tmp_path / "absent") is None

    def test_stale_tmp_is_replaced_and_ignored(self, tmp_path):
        """A killed writer's ``.tmp`` is never taken for a checkpoint, and the
        next save of that step replaces it."""
        (tmp_path / "step_00000009.tmp").mkdir()
        ckpt.save(tmp_path, 3, {"a": torch.zeros(2)})
        assert ckpt.latest_step(tmp_path) == 3
        ckpt.save(tmp_path, 9, {"a": torch.ones(2)})
        assert ckpt.latest_step(tmp_path) == 9
        assert not list(tmp_path.glob("*.tmp"))

    def test_bf16_round_trip_is_bit_exact(self, tmp_path):
        g = torch.Generator().manual_seed(0)
        w = (torch.randn(64, 33, generator=g) * 1e3).to(torch.bfloat16)
        w[0, :4] = torch.tensor([float("inf"), float("-inf"), float("nan"), -0.0])
        opt = {"m": {"w": torch.randn(64, 33, generator=g).to(torch.bfloat16)},
               "v": {"w": torch.rand(64, 33, generator=g)},
               "step": torch.tensor(3, dtype=torch.int32)}
        ckpt.save(tmp_path, 3, {"w": w}, opt)
        state, _ = ckpt.load(tmp_path, 3)
        back = state["params"]["w"]
        assert back.dtype == torch.bfloat16
        assert torch.equal(back.view(torch.int16), w.view(torch.int16))
        assert torch.equal(state["opt"]["m"]["w"].view(torch.int16),
                           opt["m"]["w"].view(torch.int16))
        assert torch.equal(state["opt"]["v"]["w"], opt["v"]["w"])

    def test_resume_after_simulated_failure(self, tmp_path):
        """Trainer-style restart: state at the last checkpoint survives."""
        from repro_torch.configs import get_smoke
        from repro_torch.models.config import Shape
        from repro_torch.train.loop import Trainer, TrainerConfig

        cfg = get_smoke("smollm-360m")
        t = Trainer(cfg, Shape("t", "train", 16, 2), device="cpu",
                    tcfg=TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=2, log_every=100))
        toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
        t.run(iter([toks] * 4), 4)
        step_before = t.step
        # simulate a crash: new trainer, resume
        t2 = Trainer(cfg, Shape("t", "train", 16, 2), device="cpu",
                     tcfg=TrainerConfig(ckpt_dir=str(tmp_path)))
        assert t2.try_resume()
        assert t2.step == 4 and step_before == 4
        for name, p in t.params.items():
            assert torch.equal(t2.params[name], p), name
            assert torch.equal(t2.opt_state["m"][name], t.opt_state["m"][name]), name
        assert int(t2.opt_state["step"]) == 4


class TestCompression:
    @given(st.integers(0, 20))
    @settings(max_examples=20, deadline=None)
    def test_int8_bounded_error(self, seed):
        rng = np.random.default_rng(seed)
        g = torch.from_numpy(rng.standard_normal(256).astype(np.float32))
        c, err = comp.compress_leaf(g)
        back = comp.decompress_leaf(c)
        assert float((back - g).abs().max()) <= float(c.scale) / 2 + 1e-6
        np.testing.assert_allclose((back + err).numpy(), g.numpy(), atol=1e-5)

    def test_error_feedback_unbiased_over_steps(self):
        """Accumulated EF-compressed gradients track the true sum."""
        rng = np.random.default_rng(0)
        true_sum = np.zeros(64)
        applied = np.zeros(64)
        err = {"g": torch.zeros(64)}
        for _ in range(50):
            g = rng.standard_normal(64).astype(np.float32) * 0.01
            true_sum += g
            c, err = comp.compress_tree({"g": torch.from_numpy(g)}, err)
            applied += comp.decompress_tree(c)["g"].numpy()
        resid = np.abs(true_sum - applied).max()
        assert resid < 0.01, resid


class TestPackingData:
    def test_packing_os4m_beats_hash(self, rng):
        docs = [np.ones(int(n), np.int32)
                for n in np.clip(rng.lognormal(4.5, 1.0, 400), 4, 2000)]
        _, s_hash = packing.pack_documents(docs, 16, 512, scheduler="hash")
        _, s_os4m = packing.pack_documents(docs, 16, 512, scheduler="os4m")
        assert s_os4m.efficiency >= s_hash.efficiency - 1e-9

    def test_packing_conserves_tokens(self, rng):
        docs = [rng.integers(3, 100, int(n)).astype(np.int32)
                for n in rng.integers(4, 300, 50)]
        total = sum(d.shape[0] for d in docs)
        out, stats = packing.pack_documents(docs, 8, 256, scheduler="os4m")
        assert stats.real_tokens + stats.dropped_tokens == total
        assert out.shape == (8, 256)

    def test_documents_deterministic(self):
        cfg = CorpusConfig()
        a = documents(cfg, seed=1, start=5, count=3)
        b = documents(cfg, seed=1, start=5, count=3)
        for x, y in zip(a, b):
            assert np.array_equal(x, y)

    def test_token_batches_shape(self):
        cfg = CorpusConfig(vocab=128)
        it = token_batches(cfg, seed=0, batch=4, seq_len=64)
        batch = next(it)
        assert batch.shape == (4, 64)
        assert batch.max() < 128


# ---------------------------------------------------------------------------
# Parity with the reference on the same numpy inputs
# ---------------------------------------------------------------------------


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": (13,), "c": (3, 4, 6)}
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in shapes.items()}


class TestParity:
    def test_lr_at_equals_reference(self):
        import jax.numpy as jnp

        from repro.train import optim as ro

        for kw in ({}, dict(lr=1.0, warmup_steps=10, decay_steps=100),
                   dict(lr=2e-3, warmup_steps=5, decay_steps=60, min_lr_ratio=0.0),
                   dict(warmup_steps=0, decay_steps=150)):
            for step in range(201):
                want = np.asarray(ro.lr_at(jnp.int32(step), ro.OptConfig(**kw)))
                got = lr_at(step, OptConfig(**kw)).numpy()
                assert got.dtype == want.dtype == np.float32
                assert got == want, (kw, step, got, want)

    @pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("clip_norm", [1.0, 0.0])
    def test_adamw_steps_equal_reference(self, moment_dtype, clip_norm):
        """Five steps on a random float32 tree. Gradients are small (their
        norm below the clip), so the clip scale is exactly 1 and the bf16
        moments can be compared bit for bit."""
        import jax.numpy as jnp

        from repro.train import optim as ro

        kw = dict(lr=1e-2, warmup_steps=2, decay_steps=20, moment_dtype=moment_dtype,
                  clip_norm=clip_norm)
        p0 = _tree(0)
        ref_p = {k: jnp.asarray(v) for k, v in p0.items()}
        ref_o = ro.init_opt(ref_p, ro.OptConfig(**kw))
        port_p = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
        port_o = init_opt(port_p, OptConfig(**kw))
        for step in range(5):
            g = _tree(100 + step, scale=0.01)
            ref_p, ref_o, rm = ro.adamw_step(ref_p, {k: jnp.asarray(v) for k, v in g.items()},
                                             ref_o, ro.OptConfig(**kw))
            port_p, port_o, pm = adamw_step(port_p, {k: torch.from_numpy(v) for k, v in
                                                     g.items()}, port_o, OptConfig(**kw))
            np.testing.assert_allclose(float(pm["grad_norm"]), float(rm["grad_norm"]),
                                       rtol=1e-6)
            assert float(pm["lr"]) == float(rm["lr"])
            assert int(port_o["step"]) == int(ref_o["step"]) == step + 1
            for k in p0:
                np.testing.assert_allclose(port_p[k].numpy(), np.asarray(ref_p[k]),
                                           atol=ATOL, rtol=RTOL)
                for mom in ("m", "v"):
                    got, want = port_o[mom][k], ref_o[mom][k]
                    if moment_dtype == "bfloat16":
                        assert got.dtype == torch.bfloat16
                        np.testing.assert_array_equal(
                            got.view(torch.int16).numpy(),
                            np.asarray(want).view(np.int16))
                    else:
                        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                                   atol=ATOL, rtol=RTOL)

    def test_adamw_clipped_steps_allclose_reference(self):
        """Gradients above the clip: the scale is a float32 division of
        norms, allclose."""
        import jax.numpy as jnp

        from repro.train import optim as ro

        kw = dict(lr=1e-2, warmup_steps=2, decay_steps=20)
        p0 = _tree(1)
        ref_p = {k: jnp.asarray(v) for k, v in p0.items()}
        ref_o = ro.init_opt(ref_p, ro.OptConfig(**kw))
        port_p = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
        port_o = init_opt(port_p, OptConfig(**kw))
        for step in range(5):
            g = _tree(200 + step, scale=3.0)
            ref_p, ref_o, _ = ro.adamw_step(ref_p, {k: jnp.asarray(v) for k, v in g.items()},
                                            ref_o, ro.OptConfig(**kw))
            port_p, port_o, pm = adamw_step(port_p, {k: torch.from_numpy(v) for k, v in
                                                     g.items()}, port_o, OptConfig(**kw))
            assert float(pm["grad_norm"]) > 1.0
        for k in p0:
            np.testing.assert_allclose(port_p[k].numpy(), np.asarray(ref_p[k]),
                                       atol=ATOL, rtol=RTOL)

    def test_chunked_leaf_update_equals_whole(self, monkeypatch):
        """A leaf updated in slabs of rows gives the same bits as whole."""
        from repro_torch.train import optim as po

        g = torch.from_numpy(np.random.default_rng(3).standard_normal((9, 4, 5))
                             .astype(np.float32))
        out = []
        for chunk in (po.CHUNK, 20):
            monkeypatch.setattr(po, "CHUNK", chunk)
            params = {"w": torch.ones(9, 4, 5)}
            opt = init_opt(params, OptConfig(warmup_steps=1))
            for _ in range(3):
                _, _, m = adamw_step(params, {"w": g}, opt, OptConfig(warmup_steps=1))
            out.append((params["w"].clone(), opt["v"]["w"].clone(), m["grad_norm"]))
        assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
        torch.testing.assert_close(out[0][2], out[1][2], rtol=1e-6, atol=0)

    def test_compress_leaf_equals_reference(self):
        import jax.numpy as jnp

        from repro.train import compression as rc

        for seed in range(5):
            g = np.random.default_rng(seed).standard_normal(1000).astype(np.float32) * 10
            rcomp, rerr = rc.compress_leaf(jnp.asarray(g))
            pcomp, perr = comp.compress_leaf(torch.from_numpy(g))
            np.testing.assert_array_equal(pcomp.q.numpy(), np.asarray(rcomp.q))
            assert pcomp.q.dtype == torch.int8
            assert float(pcomp.scale) == float(rcomp.scale)
            np.testing.assert_array_equal(perr.numpy(), np.asarray(rerr))

    @pytest.mark.parametrize("scheduler", ["os4m", "lpt", "hash"])
    def test_pack_documents_equals_reference(self, scheduler):
        from repro.data import packing as rp

        rng = np.random.default_rng(7)
        docs = [rng.integers(3, 500, int(n)).astype(np.int32)
                for n in np.clip(rng.lognormal(4.5, 1.0, 300), 4, 1500)]
        got, gs = packing.pack_documents(docs, 16, 512, scheduler=scheduler)
        want, ws = rp.pack_documents(docs, 16, 512, scheduler=scheduler)
        np.testing.assert_array_equal(got, want)
        assert dataclasses.asdict(gs) == dataclasses.asdict(ws)

    def test_documents_and_token_batches_equal_reference(self):
        from repro.data import synthetic as rs

        for kw in ({}, dict(vocab=49152), dict(vocab=512, zipf_alpha=1.3)):
            a = documents(CorpusConfig(**kw), seed=3, start=10, count=20)
            b = rs.documents(rs.CorpusConfig(**kw), seed=3, start=10, count=20)
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
            it_p = token_batches(CorpusConfig(**kw), seed=1, batch=4, seq_len=128)
            it_r = rs.token_batches(rs.CorpusConfig(**kw), seed=1, batch=4, seq_len=128)
            for _ in range(3):
                np.testing.assert_array_equal(next(it_p), next(it_r))
