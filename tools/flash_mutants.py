#!/usr/bin/env python3
"""Check that the bf16 flash tolerance still catches faults in the
tensor-core kernels.

    PYTHONPATH=src python3 tools/flash_mutants.py

Each mutant is ``csrc/flash_attention.cu`` with one edit (a mask off by
one row or one key, a live tile dropped, an interior tile dropped only
for the rows or keys past 1024 of a long sequence; in the head_dim 256
dk/dv kernel, its dK or its dV warpgroup's output dropped, or its window
bound a query tile short), built by nvcc with
the headers it includes into a temporary directory (``tools/_mutate.py``;
the checkout is not touched) and loaded in place
of the library. The unedited source runs first as the control. Each
runs every bf16 row of ``chip_smoke.FLASH_CASES`` (S 37 to tinyllama's
2048) against the plain versions and prints one JSON line a (mutant,
case): for o, dq, dk and dv (the backward given the plain forward's o
and lse) the gap over each row's scale and the largest share of the
allowance used (``flash_attention.bf16_gaps``), that share against an
allowance scaled by the tensor's largest value instead of the row's,
and whether the ``BF16_TOL`` check fails (a NaN fails it). Exits 1 if
the control fails, a mutant passes every case, a mutant of the head_dim
256 dk/dv kernel passes every head_dim 256 case, or any other mutant
passes the one-query-head-a-KV-head cases (``G1_CASES``, musicgen-large's
MHA at head_dim 64: its serving prefill, its whole 1536-token context,
which the mutants of rows and keys past 1024 need, and a ragged window,
which the window mutants need). Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import concurrent.futures
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# the cases with one query head a KV head (G 1), at one of which every
# mutant but the head_dim 256 kernel's must fail: FLASH_CASES' two
# musicgen rows, and here a ragged window, which the window mutants need
G1_WINDOW = ("g1_window", 1, 8, 8, 300, 64, 100, "bfloat16")
G1_CASES = ("musicgen_prefill", "musicgen_ctx", G1_WINDOW[0])

# (name, the source's text, its replacement, the occurrence to edit)
MUTANTS = [
    ("control", None, None, 0),
    ("fwd_mask_drops_the_diagonal",
     "if (col > row || (window > 0 && row - col >= window))",
     "if (col >= row || (window > 0 && row - col >= window))", 0),
    ("fwd_drops_the_first_live_tile",
     "const int t0 = k_begin / BK, t1",
     "const int t0 = k_begin / BK + 1, t1", 0),
    ("dq_mask_drops_the_diagonal",
     "const bool live = !edge || (col <= row &&",
     "const bool live = !edge || (col < row &&", 0),
    ("dkdv_window_one_row_wide",
     "(window <= 0 || qpos - key < window)",
     "(window <= 0 || qpos - key <= window)", 0),
    ("dkdv_drops_the_diagonal_tile",
     "const int t0 = k0 / BQ, nt",
     "const int t0 = k0 / BQ + 1, nt", 0),
    # the third key tile, for query tiles from row 1024 on only
    ("fwd_late_rows_drop_an_interior_tile",
     "const bool dead = r0 >= S ||",
     "const bool dead = (q0 >= 1024 && t == t0 + 2) || r0 >= S ||", 0),
    ("dq_late_rows_drop_an_interior_tile",
     "const bool dead = r0 >= S ||",
     "const bool dead = (q0 >= 1024 && t == t0 + 2) || r0 >= S ||", 1),
    # the second query tile, for key blocks from key 1024 on only
    ("dkdv_late_keys_drop_an_interior_tile",
     "const bool dead = kc >= S ||",
     "const bool dead = (k0 >= 1024 && i % nt == 1) || kc >= S ||", 0),
    # head_dim 256's split dk/dv kernel: one warpgroup's half of the
    # outputs, and the last query tile of a window
    ("split_dkdv_drops_the_dk_products",
     "MMA<D>::rs(acc, pa[kk], mndesc<D>(rows, BQ, kk));",
     "if (v_half) MMA<D>::rs(acc, pa[kk], mndesc<D>(rows, BQ, kk));", 0),
    ("split_dkdv_drops_the_dv_half",
     "const float mul = v_half ? 1.f : scale;",
     "const float mul = v_half ? 0.f : scale;", 0),
    ("split_dkdv_window_a_tile_short",
     "const int q_last = window > 0 ? min(S, k0 + BKV - 1 + window) : S;",
     "const int q_last = window > 0 ? min(S, k0 + BKV - 1 + window - BQ) "
     ": S;", 0),
]


def main() -> int:
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from _mutate import build, loaded
    from repro_torch.kernels import flash_attention as FA

    cases = [c for c in chip_smoke.FLASH_CASES if c[7] == "bfloat16"]
    cases.append(G1_WINDOW)
    caught, caught_256, caught_g1 = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        with concurrent.futures.ThreadPoolExecutor(len(MUTANTS)) as pool:
            libs = dict(zip([m[0] for m in MUTANTS], pool.map(
                lambda m: build("flash_attention", Path(tmp), [
                    ("flash_attention.cu", *m[1:])] if m[1] else [], m[0]),
                MUTANTS)))
        for name, lib_file in libs.items():
            with loaded("flash_attention", lib_file, FA._bind):
                caught[name] = caught_256[name] = caught_g1[name] = False
                gen = torch.Generator(device="cuda").manual_seed(3)
                for label, B, Hq, Hkv, S, D, window, _ in cases:
                    q, k, v, do = (torch.randn(
                        (B, S, H, D), generator=gen, device="cuda").to(
                        torch.bfloat16).transpose(1, 2)
                        for H in (Hq, Hkv, Hkv, Hq))
                    # each pass on the plain forward's o and lse, so that a
                    # broken forward cannot spoil the backward's reference
                    o, _ = FA.flash_attention_fwd(q, k, v, window=window)
                    o_p, lse_p = FA.flash_attention_plain(q, k, v,
                                                          window=window)
                    got = FA.flash_attention_bwd(q, k, v, o_p, lse_p, do,
                                                 window=window)
                    want = FA.flash_attention_bwd_plain(
                        q, k, v, o_p, lse_p, do, window=window)
                    gaps, used, used_of_max = {}, {}, {}
                    for n, g, w in zip(("o", "dq", "dk", "dv"), (o, *got),
                                       (o_p, *want)):
                        gaps[n], used[n] = FA.bf16_gaps(g, w)
                        # the same share against an allowance scaled by the
                        # tensor's largest value in place of the row's
                        g, w = g.float(), w.float()
                        used_of_max[n] = float(((g - w).abs() / (
                            FA.BF16_TOL * (w.abs().max() + w.abs()))).max())
                    fails = not all(u <= 1 for u in used.values())
                    caught[name] |= fails
                    caught_256[name] |= fails and D == 256
                    caught_g1[name] |= fails and label in G1_CASES
                    print(json.dumps(dict(mutant=name, case=label, gaps=gaps,
                                          used=used, used_of_max=used_of_max,
                                          check_fails=fails)), flush=True)
                    del q, k, v, do, o, o_p, lse_p, got, want
                    torch.cuda.empty_cache()
    ok = not caught["control"] and all(
        v for k, v in caught.items() if k != "control")
    # the split kernel's mutants must fail at head_dim 256 itself
    ok &= all(caught_256[k] for k in caught_256 if k.startswith("split_"))
    # and the others at G 1
    ok &= all(caught_g1[k] for k in caught_g1
              if k != "control" and not k.startswith("split_"))
    print(json.dumps(dict(caught=caught, caught_at_256=caught_256,
                          caught_at_g1=caught_g1, ok=ok)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
