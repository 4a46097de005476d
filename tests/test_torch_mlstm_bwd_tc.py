"""The tensor-core path of the mLSTM backward, on the CPU: its arithmetic
repeated in plain PyTorch (``mlstm_chunk_bwd_tc_emulate``: each f32
operand split into bf16 hi + lo where the kernels split it, S, scale dP,
C_c and dC kept as hi + lo where the kernels keep them in scratch),
its operation count, and the wrapper's choice of path.

At one (b, h) of xlstm-1.3b's train width (S 512, Dk 512, Dv 1024, two
256-token chunks, bf16 q, k, v, the forget gate of its first head:
logsigmoid(3 + N(0, 1)), models/ssm.py's bias) the emulation stays
within ``mlstm_chunk.bwd_gap`` (rtol 1e-4, atol 1e-4 * max, bf16 outputs
with their one rounding on top) of the f32 plain version; with the lo
half of dnum dropped from dnum v^T (one bf16 rounding) it does not. At a
reduced shape it stays within the same allowance of ``jax.vjp`` of the
reference's ``_mlstm_chunk_scan``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import ssm as jssm
from repro_torch.kernels import _build
from repro_torch.kernels import mlstm_chunk as MC

NAMES = ("dq", "dk", "dv", "dli", "dlf")


def _inputs(seed, B, H, S, Dk, Dv, bias):
    """q, k, v in bf16, li, lf, dh in f32, from numpy; ``bias`` the
    forget gate's bias of each head."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32))

    q, k = (t(rng.standard_normal((B, H, S, Dk))).bfloat16()
            for _ in range(2))
    v = t(rng.standard_normal((B, H, S, Dv))).bfloat16()
    li = t(rng.standard_normal((B, H, S)) * 0.5)
    x = rng.standard_normal((B, H, S)) + np.reshape(bias, (1, H, 1))
    lf = t(-np.log1p(np.exp(-x)))                       # log_sigmoid
    dh = t(rng.standard_normal((B, H, S, Dv)))
    return q, k, v, li, lf, dh


def _gaps(got, want):
    return {n: MC.bwd_gap(g, w) for n, g, w in zip(NAMES, got, want)}


_prod = MC._prod


def _drops_dnums_lo(a, b, split_a, split_b, name):
    """``mlstm_chunk._prod`` with dnum's lo half dropped from dnum v^T."""
    return (a.bfloat16().float() @ b if name == "dnum_v"
            else _prod(a, b, split_a, split_b, name))


def test_emulation_within_the_allowance_at_the_train_width(monkeypatch):
    q, k, v, li, lf, dh = _inputs(0, 1, 1, 512, 512, 1024, [3.0])
    h, _ = MC.mlstm_chunk_plain(q, k, v, li, lf, chunk=256)
    want = MC.mlstm_chunk_bwd_plain(q.float(), k.float(), v.float(), li, lf,
                                    h, dh, chunk=256)
    got = MC.mlstm_chunk_bwd_tc_emulate(q, k, v, li, lf, h, dh, chunk=256)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32] * 2
    gaps = _gaps(got, want)
    assert max(gaps.values()) <= 1, gaps
    monkeypatch.setattr(MC, "_prod", _drops_dnums_lo)
    dropped = _gaps(MC.mlstm_chunk_bwd_tc_emulate(
        q, k, v, li, lf, h, dh, chunk=256), want)
    assert max(dropped.values()) > 1, dropped


def test_emulation_matches_jax_vjp():
    B, H, S, Dk, Dv, chunk = 1, 2, 64, 16, 32, 32
    q, k, v, li, lf, dh = _inputs(1, B, H, S, Dk, Dv, [3.0, 6.0])
    wide = [x.float().numpy() for x in (q, k, v, li, lf)]

    def scan(q, k, v, li, lf):
        return jssm._mlstm_chunk_scan(
            q, k, v, li, lf, jnp.zeros((B, H, Dk, Dv)), jnp.zeros((B, H, Dk)),
            jnp.zeros((B, H)), chunk)[0]

    @jax.jit
    def grads(q, k, v, li, lf, dh):
        # one compiled program for h and its gradient (half the compile
        # time of an eager jax.vjp)
        h, vjp = jax.vjp(scan, q, k, v, li, lf)
        return h, vjp(dh)

    h, want = grads(*map(jnp.asarray, wide), jnp.asarray(dh.numpy()))
    want = [torch.from_numpy(np.array(g)) for g in want]
    got = MC.mlstm_chunk_bwd_tc_emulate(
        q, k, v, li, lf, torch.from_numpy(np.array(h)), dh, chunk=chunk)
    gaps = _gaps(got, want)
    assert max(gaps.values()) <= 1, gaps


def test_tensor_core_operation_count():
    """The products as the tensor-core kernels issue them: 106.3 GFLOP at
    xlstm's train shape, 119.2 at B 1 x S 2048, about twice the
    function's own 50.5 (``mlstm_bwd_flops``, which the bound takes)."""
    flops = MC.mlstm_bwd_tc_flops(4, 4, 512, 512, 1024, 256)
    per_chunk = (2 * 256 * 256 * 512 + 4 * 256 * 256 * 1024
                 + 6 * 256 * 512 * 1024 + 4 * 256 * 512 * 1024
                 + 8 * 64 * 64 * 512 * 10 + 4 * 1024 * 256 * 512
                 + 6 * 1024 * 256 * 256)
    assert flops == 16 * (4 * 256 * 512 * 1024 * 2 // 2 * 2 + 2 * per_chunk)
    assert round(flops / 1e9, 1) == 106.3
    assert round(MC.mlstm_bwd_tc_flops(1, 4, 2048, 512, 1024, 256) / 1e9,
                 1) == 119.2
    assert 2 < flops / MC.mlstm_bwd_flops(4, 4, 512, 512, 1024, 256) < 2.2


class _Lib:
    """Stands in for the built library: records the path each launch
    asks for."""

    def __init__(self):
        self.paths = []

    def mlstm_chunk_bwd_workspace(self, *args):
        self.paths.append(args[-1])
        return 64

    def mlstm_chunk_bwd_launch(self, *args):
        assert args[14] == self.paths[-1]
        return 0


def test_wrapper_takes_the_path_uses_tensor_cores_names(monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(_build, "load", lambda name, bind: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    cases = [(torch.bfloat16, 512, 128, 64, 256, True),
             (torch.bfloat16, 512, 1024, 256, 512, True),
             (torch.float32, 512, 128, 64, 256, False),
             (torch.bfloat16, 256, 128, 64, 256, False),   # Dk
             (torch.bfloat16, 512, 96, 64, 256, False),    # Dv
             (torch.bfloat16, 512, 128, 32, 256, False)]   # W
    for dt, Dk, Dv, W, S, tc in cases:
        q, k = (torch.zeros((1, 2, S, Dk), dtype=dt) for _ in range(2))
        v = torch.zeros((1, S, 2, Dv), dtype=dt).transpose(1, 2)
        li = lf = torch.zeros((1, 2, S))
        h = dh = torch.zeros((1, 2, S, Dv))
        assert MC.uses_tensor_cores(q, k, v, W) is tc
        MC._bwd_kernels(q, k, v, li, lf, h, dh, W)
        assert lib.paths[-1] == int(tc), (dt, Dk, Dv, W)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
