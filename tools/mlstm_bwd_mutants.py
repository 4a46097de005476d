#!/usr/bin/env python3
"""Check that the backward's check tells a fault in mlstm_chunk_bwd's
kernels from rounding.

    PYTHONPATH=src python3 tools/mlstm_bwd_mutants.py

Each mutant is ``csrc/mlstm_chunk_bwd.cu`` with one fault. In the FMA
kernels (f32 inputs): the inter-chunk dC dropped (no dC reaches an
earlier chunk); the decayed dC dropped (each chunk's dC starts from the
next chunk's rows alone); the stabiliser differentiated (the exp(-m)
branch of the denominator's max treated as the |den| branch); dlf
without the later chunks (no dg g or sum dw w at a chunk's last row); v's
strides taken as those of a contiguous (B, H, S, Dv) tensor. In the
tensor-core kernels (bf16 inputs): the sweep's products dropped (no dC
reaches an earlier chunk); the chain's decay g skipped in the reverse
sweep (dC carried undecayed) and, its twin, in the states' chain (C_c
undecayed); the lo half of (w v) dropped from the states' (w v)^T k; the
lo half of dnum dropped from dnum v^T (dnum carried as one bf16
rounding); the stabiliser differentiated. Each
is built by nvcc into a temporary directory (the checkout is not
touched) and loaded in place of the library; the unedited source runs
first as the control. Every case runs against ``mlstm_chunk_bwd_plain``
on the same inputs widened exactly, and one JSON line a (mutant, case)
gives the largest share of the allowance (``mlstm_chunk.bwd_gap``) that
any gradient uses and whether the check fails. Exits 1 if the control
fails or a mutant passes a full-width case named beside it ("train", B
4 x S 512, and "ctx", B 1 x S 2048, at xlstm-1.3b's widths and forget
gates, in f32 for the FMA kernels and in bf16 for the tensor cores).
Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import concurrent.futures
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = "mlstm_chunk_bwd.cu"

# (name, its edits: (file, the text, its replacement[, occurrence]), the
# full-width cases it must fail). Dropping the decayed g dC of the chunks
# after the next one, or skipping the decay g of the tensor-core chains,
# shows only across three chunks or more: at "ctx" (at two chunks the
# chains decay only their zero start)
MUTANTS = [
    ("control", [], ()),
    ("drops_the_inter_chunk_dc", [
        (SRC, "        float* cp = &dCs[d * DVB + tx * 4 + j];\n"
              "        *cp = g * *cp + acc2[i][j];",
         "        float* cp = &dCs[d * DVB + tx * 4 + j];\n"
         "        *cp = g * *cp;")], ("train", "ctx")),
    ("drops_the_decayed_dc", [
        (SRC, "        float* cp = &dCs[d * DVB + tx * 4 + j];\n"
              "        *cp = g * *cp + acc2[i][j];",
         "        float* cp = &dCs[d * DVB + tx * 4 + j];\n"
         "        *cp = acc2[i][j];")], ("ctx",)),
    ("differentiates_the_stabiliser", [
        (SRC, "fabsf(den) >= floor ? (-(den > 0.f ? 1.f : -1.f) * delta) / M",
         "true ? (-(den > 0.f ? 1.f : -1.f) * delta) / M")], ("train", "ctx")),
    ("dlf_without_later_chunks", [
        (SRC, "    dlf[base + W - 1] += dg * w.decay[chunk] + sdw;\n", "")],
     ("train", "ctx")),
    ("contiguous_v_strides", [
        (SRC, "  const Strides sv{strides[6], strides[7], strides[8]};",
         "  const Strides sv{(long long)dm.H * dm.S * dm.Dv,\n"
         "                   (long long)dm.S * dm.Dv, (long long)dm.Dv};")],
     ("train", "ctx")),
    ("tc_drops_the_inter_chunk_dc", [
        (SRC, "      mma_rs_n256_mn(acc, hi[kk], bd);\n"
              "      mma_rs_n256_mn(acc, lo[kk], bd);\n",
         "      if (!REV) {\n"
         "        mma_rs_n256_mn(acc, hi[kk], bd);\n"
         "        mma_rs_n256_mn(acc, lo[kk], bd);\n"
         "      }\n")], ("train_bf16", "ctx_bf16")),
    ("tc_skips_the_dc_decay", [
        (SRC, "for (int u = 0; u < 128; ++u) acc[u] *= g;",
         "for (int u = 0; u < 128; ++u) acc[u] *= REV ? 1.f : g;")],
     ("ctx_bf16",)),
    ("tc_skips_the_state_decay", [
        (SRC, "for (int u = 0; u < 128; ++u) acc[u] *= g;",
         "for (int u = 0; u < 128; ++u) acc[u] *= REV ? g : 1.f;")],
     ("ctx_bf16",)),
    ("tc_drops_the_lo_half_of_the_states_w_v", [
        (SRC, "      mma_rs_n256_mn(acc, lo[kk], bd);\n",
         "      if (REV) mma_rs_n256_mn(acc, lo[kk], bd);\n")],
     ("train_bf16", "ctx_bf16")),
    ("tc_drops_the_lo_half_of_dnum", [
        (SRC, "      mma_rs_n256<0>(acc, lo[kk], kmaj(slot, kk));\n", "")],
     ("train_bf16", "ctx_bf16")),
    ("tc_differentiates_the_stabiliser", [
        (SRC, "    const float dd = fabsf(den) >= floor\n",
         "    const float dd = true\n")], ("train_bf16", "ctx_bf16")),
]
# (label, B, H, S, Dk, Dv, chunk, li shift, forget gates): two chunks or
# more, v a strided view, one case where the exp(-m) branch wins on some
# rows, each in the input type that picks its path (bf16 at Dk 512: the
# tensor cores). "model": lf = logsigmoid(b_h + N(0, 1)) with xlstm's
# forget biases
# b_h = linspace(3, 6) over the heads (models/ssm.py), a decay of e^-0.6
# to e^-12.5 over a 256-token chunk; "steep": logsigmoid(N(0, 1) + 2),
# e^-33 over 256 tokens, which only short chunks carry across
CASES = [("small", 2, 2, 128, 32, 32, 32, 0.0, "steep", "float32"),
         ("floor_branch", 1, 2, 64, 8, 16, 16, -8.0, "steep", "float32"),
         ("train", 4, 4, 512, 512, 1024, 256, 0.0, "model", "float32"),
         ("ctx", 1, 4, 2048, 512, 1024, 256, 0.0, "model", "float32"),
         ("narrow_tc", 1, 2, 256, 512, 128, 64, 0.0, "steep", "bfloat16"),
         ("train_bf16", 4, 4, 512, 512, 1024, 256, 0.0, "model", "bfloat16"),
         ("ctx_bf16", 1, 4, 2048, 512, 1024, 256, 0.0, "model", "bfloat16")]


def main() -> int:
    import torch
    sys.path.insert(0, str(ROOT / "tools"))
    from _mutate import build, loaded
    from repro_torch.kernels import mlstm_chunk as MC

    caught = {}
    with tempfile.TemporaryDirectory() as tmp:
        with concurrent.futures.ThreadPoolExecutor(len(MUTANTS)) as pool:
            libs = dict(zip([m[0] for m in MUTANTS], pool.map(
                lambda m: build("mlstm_chunk_bwd", Path(tmp), m[1], m[0]),
                MUTANTS)))
        for name, lib_file in libs.items():
            with loaded("mlstm_chunk_bwd", lib_file, MC._bind_bwd):
                caught[name] = []
                gen = torch.Generator(device="cuda").manual_seed(5)
                for (label, B, H, S, Dk, Dv, chunk, shift, gates,
                     dt) in CASES:
                    def rand(*shape):
                        return torch.randn(shape, generator=gen,
                                           device="cuda")
                    dt = getattr(torch, dt)
                    q, k = rand(B, H, S, Dk).to(dt), rand(B, H, S, Dk).to(dt)
                    v = rand(B, S, H, Dv).to(dt).transpose(1, 2)
                    li = rand(B, H, S) * 0.5 + shift
                    bias = (torch.linspace(3.0, 6.0, H, device="cuda")
                            [:, None] if gates == "model" else 2.0)
                    lf = torch.nn.functional.logsigmoid(rand(B, H, S)
                                                        + bias)
                    h, _ = MC.mlstm_chunk(q, k, v, li, lf, chunk=chunk)
                    dh = rand(B, H, S, Dv)
                    got = MC.mlstm_chunk_bwd(q, k, v, li, lf, h, dh,
                                             chunk=chunk)
                    want = MC.mlstm_chunk_bwd_plain(
                        q.float(), k.float(), v.float(), li, lf, h, dh,
                        chunk=chunk)
                    used = {n: MC.bwd_gap(g, w) for n, g, w in zip(
                        ("dq", "dk", "dv", "dli", "dlf"), got, want)}
                    fails = not max(used.values()) <= 1
                    if fails:
                        caught[name].append(label)
                    print(json.dumps(dict(
                        mutant=name, case=label, shape=[B, H, S, Dk, Dv],
                        chunk=chunk, path="tensor_cores"
                        if MC.uses_tensor_cores(q, k, v, chunk) else "fma",
                        used=used, check_fails=fails)), flush=True)
                    del q, k, v, h, dh, got, want
                    torch.cuda.empty_cache()
    # the control passes everywhere; every mutant fails at the full-width
    # cases named beside it, the model's own gates and widths
    ok = not caught["control"] and all(
        set(must) <= set(caught[name]) for name, _, must in MUTANTS)
    print(json.dumps(dict(caught=caught, ok=ok)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
