"""Run chosen phases of ``chip_smoke.py`` on the card, each timed and
each failure caught and reported, so that a new path can be brought up
and sized without the whole script.

    python3 tools/slice_phases.py PHASE [PHASE ...]

A PHASE is the name of a ``chip_smoke.phase_*`` function without the
prefix, called with the device alone (``flash``, ``musicgen_train``,
``internvl2_train_vs_cpu``, ``recurrent_dp``, ``recurrent_cs``, ...), or
``serve_musicgen`` / ``serve_internvl2``, ``phase_serve`` as
``chip_smoke.main`` calls it for that arch. It builds the kernels first
(one nvcc per source, in parallel), prints the card's name and power
limit, and writes each phase's wall seconds and result, or its error,
to ``chiprun_out/slice_phases.json``. Exits 1 if any phase failed.
"""
import concurrent.futures
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as C  # noqa: E402


def _serve(name):
    from repro_torch.configs import get_arch
    if name == "serve_musicgen":
        return lambda dev: C.phase_serve(dev, get_arch("musicgen-large"),
                                         **C.MUSICGEN_SERVE)
    return lambda dev: C.phase_serve(
        dev, dataclasses.replace(get_arch("internvl2-76b"),
                                 num_layers=C.INTERNVL_SERVE_LAYERS),
        **C.INTERNVL_SERVE, draw_in_dtype=True)


def main(names) -> int:
    import torch
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(C.KERNELS)) as pool:
        list(pool.map(_build.build, C.KERNELS))
    print(C.gpu_line(), flush=True)
    out = {"build_s": time.perf_counter() - t0, "card": C.gpu_line()}
    failed = False
    for name in names:
        fn = _serve(name) if name.startswith("serve_") else \
            getattr(C, "phase_" + name)
        t = time.perf_counter()
        try:
            res = fn(dev)
            out[name] = dict(ok=True, result=res)
        except Exception as e:         # noqa: BLE001 (reported, exit 1)
            failed = True
            out[name] = dict(ok=False, error=repr(e)[:2000],
                             trace=traceback.format_exc()[-4000:])
            print(f"{name} FAILED: {e!r}"[:2000], flush=True)
        out[name]["seconds"] = time.perf_counter() - t
        out[name]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        print(f"{name}: {out[name]['seconds']:.1f} s", flush=True)
        torch.cuda.empty_cache()
    C.OUT_DIR.mkdir(exist_ok=True)
    (C.OUT_DIR / "slice_phases.json").write_text(
        json.dumps(out, indent=1, default=str))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
