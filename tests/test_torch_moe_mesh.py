"""The port's MoE layer at four stacked expert slots against the reference's
``moe`` on a ``(1, 4)`` mesh.

The reference's parameters (``init_moe`` with a JAX key, as numpy float32)
go into the port's ``MoE`` module, and the same numpy activations through
both ``moe``s. The reference runs in subprocesses with four forced host
devices (the test run does not set ``XLA_FLAGS``), one per group of cases,
all started together when the first case runs. Outputs allclose at float32
``atol=rtol=1e-5``; expert counts and overflow equal; the auxiliary loss
allclose at ``rtol=1e-5``.

The cases moved here from ``tests/test_torch_moe.py``, unchanged, so that
``--dist loadfile`` runs them on a worker of their own.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.nn import moe as PM

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
ATOL = RTOL = 1e-5

_CASES4 = {
    "a2a": dict(num_experts=8, strategy="a2a", t=8, capacity=None),
    "a2a-chunked": dict(num_experts=8, strategy="a2a", pipeline_chunks=2, t=8, capacity=None),
    "a2a-drops": dict(num_experts=8, strategy="a2a", pipeline_chunks=2, t=8, capacity=2),
    "broadcast": dict(num_experts=8, strategy="broadcast", t=8, capacity=None),
    "decode": dict(num_experts=8, strategy="a2a", t=1, capacity=None),
    "decode-drops": dict(num_experts=8, strategy="a2a", t=1, capacity=1),
    "tp-regime": dict(num_experts=6, strategy="a2a", t=8, capacity=None),
    "shared": dict(num_experts=8, strategy="a2a", t=8, capacity=None, shared_experts=1),
}
# One reference subprocess per group.
_GROUPS = {
    "prefill": ("a2a", "a2a-chunked", "a2a-drops"),
    "decode": ("decode", "decode-drops"),
    "other": ("broadcast", "tp-regime", "shared"),
}
_GROUP_OF = {name: group for group, names in _GROUPS.items() for name in names}

_REFERENCE_M4 = textwrap.dedent('''
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.nn import layers as RL
    from repro.nn.moe import MoEArgs, init_moe, moe

    cases, out = eval(sys.argv[1]), sys.argv[2]
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(1, 4), ("data", "model"))
    saved = {}
    for name, case in cases.items():
        case = dict(case)
        t, cap = case.pop("t"), case.pop("capacity")
        args = MoEArgs(top_k=2, d_model=16, d_ff=32, capacity_factor=2.0, **case)
        vals, _ = RL.split(init_moe(jax.random.PRNGKey(0), args, mesh))
        x = np.random.default_rng(1).standard_normal((2, t, 16)).astype(np.float32)
        y, st = moe(vals, jnp.asarray(x), args=args, mesh=mesh, capacity=cap)
        saved[name + "/y"] = np.asarray(y)
        for key in ("counts", "overflow", "aux_loss"):
            saved[name + "/" + key] = np.asarray(st[key])
        for key in ("router", "up", "down", "gate"):
            saved[name + "/w/" + key] = np.asarray(vals[key]["w"])
        if "shared" in vals:
            for key in ("up", "gate", "down"):
                saved[name + "/w/shared/" + key] = np.asarray(vals["shared"][key]["w"])
    np.savez(out, **saved)
''')


class _ReferenceM4:
    """The reference's saved arrays by ``"case/key"``. The first read starts
    every group's subprocess at once; a read waits for its own group."""

    def __init__(self, tmp):
        self.tmp = tmp
        self.data = {}
        self.procs = {}

    def _start(self) -> None:
        env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
        for group, names in _GROUPS.items():
            cases = {name: _CASES4[name] for name in names}
            out = self.tmp / f"ref_{group}.npz"
            # stderr to a file: a full pipe would stall a group not yet read.
            with open(self.tmp / f"ref_{group}.err", "w") as err:
                proc = subprocess.Popen(
                    [sys.executable, "-c", _REFERENCE_M4, repr(cases), str(out)],
                    env=env, stdout=subprocess.DEVNULL, stderr=err)
            self.procs[group] = (proc, out)

    def _wait(self, group: str) -> None:
        proc, out = self.procs.pop(group)
        try:
            proc.wait(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        err = (self.tmp / f"ref_{group}.err").read_text()
        assert proc.returncode == 0, err[-3000:]
        with np.load(out) as data:
            self.data.update({k: data[k] for k in data.files})

    def __getitem__(self, key: str):
        group = _GROUP_OF[key.split("/")[0]]
        if not self.procs and not self.data:
            self._start()
        if group in self.procs:
            self._wait(group)
        return self.data[key]

    def close(self) -> None:
        for proc, _ in self.procs.values():
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def reference_m4(tmp_path_factory):
    ref = _ReferenceM4(tmp_path_factory.mktemp("moe_m4"))
    yield ref
    ref.close()


def test_groups_cover_every_case_once():
    names = [n for group in _GROUPS.values() for n in group]
    assert sorted(names) == sorted(_CASES4)


@pytest.mark.parametrize("name", list(_CASES4))
def test_four_slot_moe_equals_reference_mesh(reference_m4, name):
    case = dict(_CASES4[name])
    t, capacity = case.pop("t"), case.pop("capacity")
    args = PM.MoEArgs(top_k=2, d_model=16, d_ff=32, capacity_factor=2.0, **case)
    module = PM.MoE(args, 4, device="cpu")
    with torch.no_grad():
        for key in ("router", "up", "down", "gate"):
            getattr(module, key).copy_(torch.from_numpy(reference_m4[f"{name}/w/{key}"]))
        if module.shared is not None:
            for key in ("up", "gate", "down"):
                module.shared[key].w.copy_(
                    torch.from_numpy(reference_m4[f"{name}/w/shared/{key}"]))
    x = np.random.default_rng(1).standard_normal((2, t, 16)).astype(np.float32)
    y, st = PM.moe(module, torch.from_numpy(x), capacity=capacity)
    np.testing.assert_allclose(y.numpy(), reference_m4[f"{name}/y"], atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(st["counts"].numpy(), reference_m4[f"{name}/counts"])
    assert int(st["overflow"]) == int(reference_m4[f"{name}/overflow"])
    np.testing.assert_allclose(float(st["aux_loss"]), float(reference_m4[f"{name}/aux_loss"]),
                               rtol=1e-5)
    if name.endswith("drops"):
        assert int(st["overflow"]) > 0
