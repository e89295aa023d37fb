"""The port's ``Trainer`` and training launcher against the reference's.

* smollm-360m's smoke twin, 6 steps, from the reference ``Trainer``'s own
  initial weights (``params_from_reference``) and the same packed batches,
  at ``microbatches`` 1 and 2: ``loss``, ``grad_norm`` and ``lr`` of every
  step allclose, final parameters allclose.
* deepseek-v2's smoke twin at four expert slots with ``replan_interval=2``
  against the reference ``Trainer`` on a ``(1, 4)`` mesh, in a subprocess
  with four forced host devices: the same, plus the placements applied at
  each re-plan, ``balance_ratio`` and ``baseline_ratio`` equal.
* The reference's behaviours the port keeps, each pinned: a re-plan moves
  the expert weights but not their AdamW moments; the failure path
  restores weights and optimizer state but neither the placements nor the
  current permutations, and rewinds ``step`` without rewinding the
  batches; with ``microbatches=2`` the step returns no expert counts and
  the balancer never observes.
* The retry path against the reference's: a step that raises once is
  retried from the last checkpoint, with the reference's step counting.
* ``python -m repro_torch.launch.train --device cpu`` as a subprocess,
  beside ``python -m repro.launch.train``: the same log lines (the step
  and lr columns equal; the loss and gnorm columns of the same format, as
  the random initial weights differ), the final checkpoint, and
  ``--resume``.

Tolerances (float32 smoke twins): losses, grad norms and lr at
``rtol=1e-5``; parameters at ``atol=1e-5, rtol=1e-4``.
"""

import dataclasses
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.data.synthetic import CorpusConfig, token_batches
from repro_torch.models.config import Shape
from repro_torch.models.convert import params_from_reference
from repro_torch.models.model import default_placements
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.train.optim import OptConfig

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
RTOL = 1e-5
P_ATOL, P_RTOL = 1e-5, 1e-4
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=8)


def _batches(cfg, n, batch, seq, zipf_alpha=1.2):
    it = token_batches(CorpusConfig(vocab=cfg.vocab, zipf_alpha=zipf_alpha), seed=0,
                       batch=batch, seq_len=seq)
    return [next(it) for _ in range(n)]


def _np_tree(tree):
    import jax

    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _assert_histories_close(got, want, keys=("loss", "grad_norm", "lr", "total_loss")):
    assert [s for s, _ in got] == [s for s, _ in want]
    for (step, g), (_, w) in zip(got, want):
        for key in keys:
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL, err_msg=f"{key} @ {step}")


def _assert_params_close(model, values, cfg, ep_slots=1):
    want = dict(params_from_reference(values, cfg, device="cpu",
                                      ep_slots=ep_slots).named_parameters())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].detach().numpy(),
                                   atol=P_ATOL, rtol=P_RTOL, err_msg=name)


# ---------------------------------------------------------------------------
# Dense: smollm-360m's smoke twin against the reference Trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatches", [1, 2])
def test_smollm_smoke_history_matches_reference(tmp_path, microbatches):
    from repro.configs import get_smoke as ref_smoke
    from repro.launch.mesh import single_device_mesh
    from repro.models.config import Shape as RShape
    from repro.train import loop as RL
    from repro.train.optim import OptConfig as ROpt

    cfg = get_smoke("smollm-360m")
    tk = dict(ckpt_every=1000, log_every=100, microbatches=microbatches)
    ref = RL.Trainer(ref_smoke("smollm-360m"), RShape("t", "train", 32, 4),
                     single_device_mesh(), opt_cfg=ROpt(**OPT),
                     tcfg=RL.TrainerConfig(ckpt_dir=str(tmp_path / "ref"), **tk))
    model = params_from_reference(_np_tree(ref.params), cfg, device="cpu")
    port = Trainer(cfg, Shape("t", "train", 32, 4), model=model, opt_cfg=OptConfig(**OPT),
                   tcfg=TrainerConfig(ckpt_dir=str(tmp_path / "port"), **tk))
    batches = _batches(cfg, 6, 4, 32)
    ref.run(iter(batches), 6)
    port.run(iter(batches), 6)
    _assert_histories_close(port.history, ref.history)
    _assert_params_close(port.model, _np_tree(ref.params), cfg)


def test_microbatches_accumulate_the_full_batch_gradient():
    """Two microbatches of equal token counts give the full batch's update
    (the mean of the two losses is the full batch's loss). Parameters within
    2e-5: a twenty-fifth of the first step's AdamW update (lr 5e-4), whose
    direction follows the sign of each gradient element, so an element near
    zero may differ by float rounding."""
    cfg = get_smoke("smollm-360m")
    batches = _batches(cfg, 1, 4, 32)
    out = []
    for mb in (1, 2):
        t = Trainer(cfg, Shape("t", "train", 32, 4), device="cpu", opt_cfg=OptConfig(**OPT),
                    tcfg=TrainerConfig(ckpt_every=1000, microbatches=mb))
        t.run(iter(batches), 1)
        out.append(t)
    np.testing.assert_allclose(out[1].history[0][1]["loss"], out[0].history[0][1]["loss"],
                               rtol=1e-6)
    np.testing.assert_allclose(out[1].history[0][1]["grad_norm"],
                               out[0].history[0][1]["grad_norm"], rtol=1e-5)
    for name, p in out[0].params.items():
        torch.testing.assert_close(out[1].params[name], p, atol=2e-5, rtol=0)


# ---------------------------------------------------------------------------
# MoE: deepseek-v2's smoke twin at four expert slots, the balancer in the loop
# ---------------------------------------------------------------------------


_STEPS4 = 6
_REFERENCE_TRAINER_M4 = textwrap.dedent('''
    import sys
    import numpy as np
    import jax
    from jax.sharding import Mesh
    from repro.configs import get_smoke
    from repro.data.synthetic import CorpusConfig, token_batches
    from repro.models.config import Shape
    from repro.train.loop import Trainer, TrainerConfig
    from repro.train.optim import OptConfig

    opt, steps, ckpt, out = eval(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    cfg = get_smoke("deepseek-v2-236b")
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(1, 4), ("data", "model"))
    t = Trainer(cfg, Shape("t", "train", 32, 4), mesh, opt_cfg=OptConfig(**opt),
                tcfg=TrainerConfig(ckpt_dir=ckpt, ckpt_every=1000, replan_interval=2,
                                   log_every=100))
    leaves = lambda tree: {jax.tree_util.keystr(k): np.asarray(v, np.float32)
                           for k, v in jax.tree_util.tree_leaves_with_path(tree)}
    saved = {"init/" + k: v for k, v in leaves(t.params).items()}
    applied = []
    apply = t._apply_placements
    def record(placements, perms):
        apply(placements, perms)
        applied.append(np.asarray(t.placements))
    t._apply_placements = record
    it = token_batches(CorpusConfig(vocab=cfg.vocab, zipf_alpha=1.3), seed=0, batch=4,
                       seq_len=32)
    batches = [next(it) for _ in range(steps)]
    t.run(iter(batches), steps)
    saved.update({"final/" + k: v for k, v in leaves(t.params).items()})
    for i, p in enumerate(applied):
        saved[f"placements/{i}"] = p
    for step, m in t.history:
        for key, v in m.items():
            saved[f"history/{step}/{key}"] = np.asarray(v)
    np.savez(out, **saved)
''')


@pytest.fixture(scope="module")
def reference_trainer_m4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer_m4")
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_TRAINER_M4, repr(OPT),
                           str(_STEPS4), str(tmp / "ckpt"), str(tmp / "ref.npz")],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(tmp / "ref.npz") as data:
        return {key: data[key] for key in data.files}


def _unflatten(flat, prefix):
    """The reference's keystr-flattened leaves back into nested dicts."""
    tree = {}
    for key, value in flat.items():
        if not key.startswith(prefix):
            continue
        parts = re.findall(r"\['([^']+)'\]", key[len(prefix):])
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def _deepseek_trainer(values, tmp_path, **tk):
    cfg = get_smoke("deepseek-v2-236b")
    model = params_from_reference(values, cfg, device="cpu", ep_slots=4)
    kw = dict(ckpt_dir=str(tmp_path), ckpt_every=1000, replan_interval=2, log_every=100)
    return cfg, Trainer(cfg, Shape("t", "train", 32, 4), model=model, opt_cfg=OptConfig(**OPT),
                        tcfg=TrainerConfig(**{**kw, **tk}))


def test_deepseek_smoke_balancer_in_the_loop_matches_reference(reference_trainer_m4,
                                                               tmp_path):
    ref = reference_trainer_m4
    cfg, port = _deepseek_trainer(_unflatten(ref, "init/"), tmp_path)
    applied = []
    apply = port._apply_placements

    def record(placements, perms):
        apply(placements, perms)
        applied.append(port.placements.numpy().copy())

    port._apply_placements = record
    port.run(iter(_batches(cfg, _STEPS4, 4, 32, zipf_alpha=1.3)), _STEPS4)
    want_applied = [ref[f"placements/{i}"] for i in range(_STEPS4)
                    if f"placements/{i}" in ref]
    assert len(applied) == len(want_applied) == _STEPS4 // 2
    for got, want in zip(applied, want_applied):
        np.testing.assert_array_equal(got, want)
    default = default_placements(cfg, 4).numpy()
    assert any((a != default).any() for a in applied)     # the balancer moved experts
    for step, m in port.history:
        for key in ("loss", "grad_norm", "lr", "total_loss"):
            np.testing.assert_allclose(m[key], float(ref[f"history/{step}/{key}"]),
                                       rtol=RTOL, err_msg=f"{key} @ {step}")
        assert m["overflow"] == float(ref[f"history/{step}/overflow"])
        for key in ("balance_ratio", "baseline_ratio"):
            assert (key in m) == (f"history/{step}/{key}" in ref)
            if key in m:
                assert m[key] == float(ref[f"history/{step}/{key}"]), (key, step)
    _assert_params_close(port.model, _unflatten(ref, "final/"), cfg, ep_slots=4)


# ---------------------------------------------------------------------------
# The reference's behaviours, pinned
# ---------------------------------------------------------------------------


def test_replan_moves_weights_but_not_moments(reference_trainer_m4, tmp_path):
    """``_apply_placements`` gathers the expert weight rows; the AdamW
    moment rows stay in place (row e's moments then belong to whichever
    expert now sits in row e), as the reference's."""
    _, port = _deepseek_trainer(_unflatten(reference_trainer_m4, "init/"), tmp_path,
                                replan_interval=1)
    seen = []
    apply = port._apply_placements

    def record(placements, perms):
        names = [n for n in port.params if ".moe." in n and n.split(".")[-1] in
                 ("up", "gate", "down")]
        before = {n: (port.params[n].detach().clone(), port.opt_state["m"][n].clone(),
                      port.opt_state["v"][n].clone()) for n in names}
        prev = port._cur_perms
        apply(placements, perms)
        for n, (w, m, v) in before.items():
            layer = int(n.split(".")[1])
            take = np.asarray(perms[layer]) if prev is None else \
                np.argsort(prev[layer])[perms[layer]]
            assert torch.equal(port.params[n].detach(), w[torch.as_tensor(take)]), n
            assert torch.equal(port.opt_state["m"][n], m), n
            assert torch.equal(port.opt_state["v"][n], v), n
        seen.append(any((np.asarray(p) != np.arange(len(p))).any() for p in perms))

    port._apply_placements = record
    port.run(iter(_batches(port.cfg, 3, 4, 32, zipf_alpha=1.3)), 3)
    assert len(seen) == 3 and any(seen)          # some re-plan moved experts


def test_failure_path_keeps_placements_and_rewinds_step(reference_trainer_m4, tmp_path):
    """A failed step restores the last checkpoint's weights and optimizer
    state; the placements and current permutations stay the live ones,
    ``step`` returns to the checkpoint's, and the retried step takes the
    batch that was fetched (the iterator is not rewound)."""
    _, port = _deepseek_trainer(_unflatten(reference_trainer_m4, "init/"), tmp_path,
                                replan_interval=1, ckpt_every=2)
    batches = _batches(port.cfg, 5, 4, 32, zipf_alpha=1.3)
    port.run(iter(batches[:3]), 3)               # checkpoint at 2, re-plans at 1-3
    saved_params = {n: p.detach().clone() for n, p in port.params.items()}
    placements, perms = port.placements.clone(), [p.copy() for p in port._cur_perms]
    step_fn, calls = port.step_fn, []

    def flaky(model, opt_state, batch, placements_):
        calls.append((batch["tokens"].clone(), placements_.clone(), int(opt_state["step"])))
        if len(calls) == 1:
            raise RuntimeError("simulated device loss")
        return step_fn(model, opt_state, batch, placements_)

    port.step_fn = flaky
    port.run(iter(batches[3:4]), 1)
    assert port.step == 3                        # rewound to 2, then one step
    assert [s for s, _ in port.history] == [1, 2, 3, 3]
    (tok0, pl0, _), (tok1, pl1, opt_step) = calls
    assert torch.equal(tok0, tok1) and torch.equal(tok1, torch.from_numpy(batches[3]))
    assert torch.equal(pl1, placements) and torch.equal(pl0, placements)
    assert opt_step == 2                         # the optimizer state of step 2
    # After the retried step the balancer re-planned again from the live perms.
    assert port._cur_perms is not None and len(port._cur_perms) == len(perms)
    assert any(not torch.equal(port.params[n], saved_params[n]) for n in saved_params)


def test_microbatches_return_no_counts_and_the_balancer_never_observes(tmp_path):
    cfg = get_smoke("deepseek-v2-236b")
    t = Trainer(cfg, Shape("t", "train", 32, 4), device="cpu", ep_slots=4,
                opt_cfg=OptConfig(**OPT),
                tcfg=TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=1000, replan_interval=1,
                                   microbatches=2))
    before = t.placements.clone()
    t.run(iter(_batches(cfg, 3, 4, 32, zipf_alpha=1.3)), 3)
    assert t.balancer is not None and t.balancer.step == 0
    assert not t.balancer.counts.any()
    assert torch.equal(t.placements, before) and t._cur_perms is None
    for _, m in t.history:
        assert "balance_ratio" not in m and "overflow" not in m
        assert np.isfinite(m["loss"])


# ---------------------------------------------------------------------------
# The retry path against the reference's
# ---------------------------------------------------------------------------


def test_retry_path_matches_reference(tmp_path):
    """A step that raises once (the 4th) is retried from the checkpoint of
    step 2 on the batch it was given: both packages count steps 1, 2, 3,
    3, 4 and agree on every loss."""
    from repro.configs import get_smoke as ref_smoke
    from repro.launch.mesh import single_device_mesh
    from repro.models.config import Shape as RShape
    from repro.train import loop as RL
    from repro.train.optim import OptConfig as ROpt

    cfg = get_smoke("smollm-360m")
    tk = dict(ckpt_every=2, log_every=100, keep=1)
    ref = RL.Trainer(ref_smoke("smollm-360m"), RShape("t", "train", 32, 2),
                     single_device_mesh(), opt_cfg=ROpt(**OPT),
                     tcfg=RL.TrainerConfig(ckpt_dir=str(tmp_path / "ref"), **tk))
    port = Trainer(cfg, Shape("t", "train", 32, 2),
                   model=params_from_reference(_np_tree(ref.params), cfg, device="cpu"),
                   opt_cfg=OptConfig(**OPT),
                   tcfg=TrainerConfig(ckpt_dir=str(tmp_path / "port"), **tk))
    for trainer in (ref, port):
        step_fn, calls = trainer.step_fn, []

        def flaky(*args, _fn=step_fn, _calls=calls):
            _calls.append(1)
            if len(_calls) == 4:
                raise RuntimeError("simulated device loss")
            return _fn(*args)

        trainer.step_fn = flaky
        trainer.run(iter(_batches(cfg, 5, 2, 32)), 5)
    assert [s for s, _ in port.history] == [s for s, _ in ref.history] == [1, 2, 3, 3, 4]
    _assert_histories_close(port.history, ref.history)


def test_trainer_runs_on_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(get_smoke("smollm-360m"), Shape("t", "train", 16, 2))


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


_LINE = re.compile(r"^step +(\d+)  loss (\d+\.\d{4})  gnorm (\d+\.\d{3})  lr (\S+)$")


def _launch(module, tmp, *extra):
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-m", module, "--batch", "2", "--seq", "32",
                           "--ckpt-dir", str(tmp), *extra], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()


def test_launcher_log_lines_match_reference(tmp_path):
    port = _launch("repro_torch.launch.train", tmp_path / "port", "--device", "cpu",
                   "--steps", "20")
    ref = _launch("repro.launch.train", tmp_path / "ref", "--steps", "20")
    assert len(port) == len(ref) == 3
    for got, want in zip(port[:2], ref[:2]):
        g, w = _LINE.match(got), _LINE.match(want)
        assert g and w, (got, want)
        assert g.group(1) == w.group(1) and g.group(4) == w.group(4)   # step, lr
    assert port[2] == f"done at step 20; checkpoints in {tmp_path / 'port'}"
    assert ref[2] == f"done at step 20; checkpoints in {tmp_path / 'ref'}"
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ["step_00000020"]
    again = _launch("repro_torch.launch.train", tmp_path / "port", "--device", "cpu",
                    "--resume", "--steps", "2")
    assert again == ["resumed from step 20",
                     f"done at step 22; checkpoints in {tmp_path / 'port'}"]


def test_launcher_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    env = {**os.environ, "PYTHONPATH": SRC}
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--steps", "1",
                           "--ckpt-dir", str(tmp_path)], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and "CUDA" in proc.stderr


@pytest.mark.gpu
@pytest.mark.parametrize("arch,ep_slots", [("smollm-360m", 1), ("deepseek-v2-236b", 4)])
def test_cuda_trainer_matches_cpu(arch, ep_slots, tmp_path):
    """The smoke twin trained on the card and on the CPU from the same
    weights and batches: losses and grad norms within 1e-4 relative,
    placements equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.models.model import init_model

    cfg = get_smoke(arch)
    batches = _batches(cfg, 4, 4, 32, zipf_alpha=1.3)
    runs = []
    for dev in ("cpu", "cuda"):
        model = init_model(cfg, seed=0, device="cpu", ep_slots=ep_slots).to(dev)
        t = Trainer(cfg, Shape("t", "train", 32, 4), model=model, opt_cfg=OptConfig(**OPT),
                    tcfg=TrainerConfig(ckpt_dir=str(tmp_path / dev), ckpt_every=1000,
                                       replan_interval=2))
        t.run(iter(batches), 4)
        runs.append(t)
    for (_, a), (_, b) in zip(runs[0].history, runs[1].history):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(b[key], a[key], rtol=1e-4)
    if runs[0].placements is not None:
        assert torch.equal(runs[1].placements.cpu(), runs[0].placements)
