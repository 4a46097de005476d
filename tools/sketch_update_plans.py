#!/usr/bin/env python3
"""Time the EMA update kernels under the split plans and kernel choices
their wrappers could make, to check the ones they do make.

    PYTHONPATH=src python3 tools/sketch_update_plans.py

For each shape below, each of sketch_update's two kernels (the tensor
cores where the shape allows them, and the FMA kernel) runs at several
T-split counts (psparse_update: splits of its 3m support slots), called
through the C entry point with that plan, back to back behind a sleep
kernel so that the card never waits for the host; prints one JSON line
a (shape, kernel, splits) with the device µs a call (CUDA events over
200 calls), whether the wrapper's ``launch_plan`` and
``uses_tensor_cores`` pick that row, and, for the tensor-core shapes,
the µs of one ``torch.matmul`` of A^T against the (T, 3k) projections.
Each row is first held to the plain version (rtol and atol 1e-4 of its
largest value). Prints the card's name and power limit first. Needs a
CUDA device and nvcc.
"""
from __future__ import annotations

import json
import subprocess
import sys

CALLS = 200
SPLITS = (1, 2, 3, 4, 6, 8, 12, 16)
# (label, T, d, k, A dtype): decode, refill and the LM's FFN nodes at
# S 128, at each DP worker's share and at tinyllama's context; the MLP
# trainer's f32 nodes
SKETCH = [("decode", 8, 2048, 9, "bfloat16"),
          ("refill", 64, 2048, 9, "bfloat16"),
          ("lm_ffn_in", 1024, 2048, 17, "bfloat16"),
          ("lm_ffn_h", 1024, 5632, 17, "bfloat16"),
          ("dp_w4_ffn_in", 256, 2048, 17, "bfloat16"),
          ("dp_w4_ffn_h", 256, 5632, 17, "bfloat16"),
          ("lm_ctx_ffn_in", 8192, 2048, 17, "bfloat16"),
          ("lm_ctx_ffn_h", 8192, 5632, 17, "bfloat16"),
          ("mnist_mlp", 128, 512, 33, "float32")]
PSPARSE = [("lm_ffn_in", 1024, 2048, 17, "bfloat16"),
           ("lm_ffn_h", 1024, 5632, 17, "bfloat16")]


def queued_us(fn) -> float:
    """Device µs a call of ``fn`` over CALLS calls enqueued behind a
    sleep kernel, so that they run back to back."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / CALLS * 1e3


def plans(rows: int, tc: bool):
    """(splits, rows_per_split) for each count in SPLITS, whole stages
    a split, without repeats."""
    from repro_torch.kernels import sketch_update as S
    step = S.TC_ROWS if tc else S.FMA_ROWS
    seen = {}
    for want in SPLITS:
        per = -(-(-(-rows // want)) // step) * step
        seen.setdefault(-(-rows // per), per)
    return sorted(seen.items())


def close(got, want) -> None:
    import torch
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()))


def main() -> int:
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import psparse_update as P
    from repro_torch.kernels import sketch_update as S

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    sms = _build.num_sms(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *s: torch.randn(s, generator=gen, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    lib = _build.load("sketch_update", S._bind)
    plib = _build.load("psparse_update", P._bind)

    for label, T, d, k, dtype in SKETCH:
        dt = getattr(torch, dtype)
        a, x, y, z = rand(T, d).to(dt), rand(d, k), rand(d, k), rand(d, k)
        u, o, p, psi = rand(T, k), rand(T, k), rand(T, k), rand(k)
        want = S.sketch_update_ref(a, x, y, z, u, o, p, psi, 0.9)
        pcat = torch.cat([u, o, p], dim=1).to(dt)
        chosen = S.uses_tensor_cores(T, d, dt)
        kinds = (True, False) if dt == torch.bfloat16 and d % 8 == 0 \
            else (False,)
        for tc in kinds:
            pick = S.launch_plan(T, d, sms, tc)
            for splits, per in plans(T, tc):
                out = torch.empty((3, d, k), device=dev)
                ws = (torch.empty((splits, 3, d, k), device=dev)
                      if splits > 1 else None)

                def call():
                    err = lib.sketch_update_launch(
                        a.data_ptr(), int(dt == torch.bfloat16), u.data_ptr(),
                        o.data_ptr(), p.data_ptr(), psi.data_ptr(),
                        x.data_ptr(), y.data_ptr(), z.data_ptr(),
                        out.data_ptr(),
                        ws.data_ptr() if ws is not None else None, T, d, k,
                        int(tc), splits, per, 0.9, stream)
                    if err:
                        raise RuntimeError(f"launch failed ({err})")
                call()
                torch.cuda.synchronize()
                close(out.unbind(0), want)
                print(json.dumps(dict(
                    kernel="sketch_update", case=label, T=T, d=d, k=k,
                    a_dtype=dtype, tensor_cores=tc, splits=splits,
                    us=queued_us(call),
                    wrapper_picks=tc == chosen and (splits, per) == pick,
                    matmul_us=queued_us(lambda: torch.matmul(a.t(), pcat))
                    if tc else None)), flush=True)

    for label, T, d, k, dtype in PSPARSE:
        dt = getattr(torch, dtype)
        m = P.psparse_dim(T, k, 0.1)
        a, x, y, z, psi = rand(T, d).to(dt), rand(d, k), rand(d, k), \
            rand(d, k), rand(k)
        coeffs = P.psparse_hash_params(torch.Generator().manual_seed(1))
        want = P.psparse_update_ref(a, x, y, z, coeffs, psi, beta=0.9, m=m)
        flat = [int(c) for row in coeffs for c in row]
        pick = S.launch_plan(3 * m, d, sms, True)
        for splits, per in plans(3 * m, True):
            out = torch.empty((3, d, k), device=dev)
            ws = (torch.empty((splits, 3, d, k), device=dev)
                  if splits > 1 else None)

            def call():
                err = plib.psparse_update_launch(
                    a.data_ptr(), 1, psi.data_ptr(), x.data_ptr(),
                    y.data_ptr(), z.data_ptr(), out.data_ptr(),
                    ws.data_ptr() if ws is not None else None, *flat, T, d,
                    k, m, 1, splits, per, P.psparse_scale(T, m), 0.9,
                    stream)
                if err:
                    raise RuntimeError(f"launch failed ({err})")
            call()
            torch.cuda.synchronize()
            close(out.unbind(0), want)
            print(json.dumps(dict(
                kernel="psparse_update", case=label, T=T, d=d, k=k, m=m,
                a_dtype=dtype, tensor_cores=True, splits=splits,
                us=queued_us(call), wrapper_picks=(splits, per) == pick)),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
