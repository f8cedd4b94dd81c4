#!/usr/bin/env python3
"""Where K8's and K1's time goes on one CUDA card: variants of their
source, each with one design choice undone, timed on the same tensors.

    python tools/torch_kernel_probe.py [--kernels k8,k1] [--out FILE]

K8 (dsjax_torch/csrc/mm_chain.cu) at T=512, H=1024, B=64 and B=16, bf16:
  as is           the kernel the port runs
  per_atom        the product's loop an atom at a time, not four (unrolled)
  one_thread      every tensor copy of h issued by thread 0, not a lane each
  z_first         z stored before the barrier's release, not after it
  no_barrier      the grid barrier's wait removed (results wrong: its cost)
  no_copy         no tensor copies of h (results wrong)
  no_product      no wgmma (results wrong)
  stamps          clock64 of every CTA's thread 0 by part of a step, in
                  registers, written once at the end

K1 (dsjax_torch/csrc/lstm_fwd.cu on scan_persist.cuh), f32, both directions,
H=1024, at the evaluation's T=577, B=20 and the serving T=501, B=8:
  as is           the kernel the port runs
  no_product      the step product's FMAs removed (results wrong)
  no_barrier      the grid barrier's wait removed (results wrong: its cost)
  stamps          clock32 of every CTA's thread 0 by part of a step, summed
                  over the step's passes, in registers, written at the end

Each variant is a copy of the source with a text substitution (the tool
stops if a substitution no longer matches), built by nvcc into its own
library under build/probe/ and called through ctypes; times are medians of
CUDA events after a warm-up, and each variant's results are compared with
the kernel's plain version where they should be right. Needs a card;
imports nothing of jax.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "dsjax_torch", "csrc")
BUILD = os.path.join(ROOT, "build", "probe")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
              "-fPIC", "-shared", f"-I{CSRC}"]

K8_STEP_PARTS = ("copies issued", "product issued (copies waited)", "product done", "epilogue",
                 "barrier arrival", "z and next xp", "barrier wait")


def sub(*pairs):
    """A variant: each (old, new) replaced once; raises if old is missing."""

    def apply(src):
        for old, new in pairs:
            if old not in src:
                raise SystemExit(f"torch_kernel_probe: the source no longer holds {old!r}")
            src = src.replace(old, new, 1)
        return src

    return apply


PRODUCT = ("          wgmma_m64n32k16(d, smem_desc(a0 + kk * 32), smem_desc(b0 + kk * 32), "
           "c > 0 || kk > 0);")
LOAD_UNITS = "      for (int u = tid; u < slots; u += 32) load_unit(s, u);\n"
WAIT_COPY = "      if constexpr (kResident) mbar_wait(full + c0 / kUnit, s & 1);\n"
WAIT = "      grid::barrier_wait(a.counter, (s + 1) * a.plan.ctas);\n"
ARRIVE = "    if (s + 1 < a.n_t) grid::barrier_arrive(a.counter);\n"

STAMPS = sub(
    ("namespace {\n\nusing namespace dsjax_torch;\n",
     "namespace {\n\nusing namespace dsjax_torch;\n__device__ long long probe_stamps[160 * 8];\n"
     "#define STAMP(i) { const long long n_ = clock64(); acc_[i] += n_ - mark_; mark_ = n_; }\n"),
    ("  load_xp(0);\n",
     "  load_xp(0);\n  long long mark_ = clock64();\n  long long acc_[8] = {};\n"),
    (LOAD_UNITS + "    }\n", LOAD_UNITS + "    }\n    STAMP(0)\n"),
    ("    wgmma_wait<0>();\n", "    STAMP(1)\n    wgmma_wait<0>();\n    STAMP(2)\n"),
    (ARRIVE, "    STAMP(3)\n" + ARRIVE + "    STAMP(4)\n"),
    ("      load_xp(s + 1);\n", "      load_xp(s + 1);\n      STAMP(5)\n"),
    (WAIT + "    }\n  }\n}\n",
     WAIT + "      STAMP(6)\n    }\n  }\n  if (threadIdx.x == 0)\n"
     "    for (int i_ = 0; i_ < 8; ++i_) probe_stamps[blockIdx.x * 8 + i_] = acc_[i_];\n}\n"))
STAMP_READER = ('\nextern "C" int probe_stamps_read(long long* out) {\n  return '
                'cudaMemcpyFromSymbol(out, probe_stamps, sizeof(long long) * 160 * 8);\n}\n')

K8_VARIANTS = {
    "as is": (sub(), True),
    "per_atom": (sub(("#pragma unroll\n      for (int u = 0; u < kUnit; ++u) {",
                      "#pragma unroll 1\n      for (int u = 0; u < kUnit; ++u) {")), True),
    "one_thread": (sub((LOAD_UNITS,
                        "      if (tid == 0) for (int u = 0; u < slots; ++u) load_unit(s, u);\n")),
                   True),
    "z_first": (sub((ARRIVE, ""),
                    ("      load_xp(s + 1);\n",
                     "      grid::barrier_arrive(a.counter);\n      load_xp(s + 1);\n")), True),
    "no_barrier": (sub((WAIT, "      __syncthreads();\n")), False),
    "no_copy": (sub((LOAD_UNITS, ""), (WAIT_COPY, "")), False),
    "no_product": (sub((PRODUCT, "          if (a.n_t < 0) " + PRODUCT.lstrip())), False),
    "stamps": (lambda src: STAMPS(src) + STAMP_READER, True),
}


def build(kernel_src, variants, prefix, header=None):
    """{name: ctypes library} of every variant, built at once. With
    ``header``, the variants change that header (a copy beside the kernel's
    copy, which its quoted include finds first) and the "stamps" variant's
    kernel gains K1_STAMP_READER; else they change the kernel's source."""
    src = open(os.path.join(CSRC, kernel_src)).read()
    head = open(os.path.join(CSRC, header)).read() if header else None
    procs = {}
    for name, (make, _) in variants.items():
        where = os.path.join(BUILD, f"{prefix}_{name.replace(' ', '_')}")
        os.makedirs(where, exist_ok=True)
        path = os.path.join(where, prefix)
        with open(path + ".cu", "w") as f:
            f.write((src + (K1_STAMP_READER if name == "stamps" else "")) if header
                    else make(src))
        if header:
            with open(os.path.join(where, header), "w") as f:
                f.write(make(head))
        procs[name] = (subprocess.Popen(["/usr/local/cuda/bin/nvcc", *NVCC_FLAGS, "-o",
                                         path + ".so", path + ".cu"], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), path + ".so")
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"torch_kernel_probe: {prefix} {name} did not build:\n{out}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def median_ms(torch, fn, reps=7):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def probe_k8(torch, log):
    from dsjax_torch.ops import _card, mm_chain

    libs = build("mm_chain.cu", K8_VARIANTS, "k8")
    p, i = ctypes.c_void_p, ctypes.c_int
    gen = torch.Generator().manual_seed(0)
    t_dim, n_h = 512, 1024
    out = {}
    for n_b in (64, 16):
        xp = torch.randn(t_dim, n_b, 4 * n_h, generator=gen).to("cuda", torch.bfloat16)
        w = (torch.randn(n_h, 4 * n_h, generator=gen) * 0.01).to("cuda", torch.bfloat16)
        h0 = torch.randn(n_b, n_h, generator=gen).to("cuda", torch.bfloat16)
        want = mm_chain.mm_chain_reference(xp, w, h0)
        plan = mm_chain.chain_plan(n_b, n_h, _card.sm_count(xp.device))
        for name, (_, right) in K8_VARIANTS.items():
            lib = libs[name]
            lib.dsjax_torch_mm_chain.argtypes = [p, p, p, p, p, p, i, i, i, p]

            def run():
                h = torch.empty((2, n_b, n_h), dtype=torch.bfloat16, device="cuda")
                h[0].copy_(h0)
                z = torch.zeros((n_b, 4 * n_h), dtype=torch.bfloat16, device="cuda")
                counter = torch.zeros(1, dtype=torch.int32, device="cuda")
                err = lib.dsjax_torch_mm_chain(xp.data_ptr(), w.data_ptr(), h.data_ptr(),
                                               z.data_ptr(), counter.data_ptr(),
                                               _card.plan_array(plan), t_dim, n_b, n_h,
                                               torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"torch_kernel_probe: K8 {name} returned {err}")
                return h[t_dim % 2], z

            ms = median_ms(torch, run)
            h, z = run()
            torch.cuda.synchronize()
            err = max((h.float() - want[0].float()).abs().max().item(),
                      (z.float() - want[1].float()).abs().max().item())
            row = {"ms": ms, "us_per_step": ms * 1e3 / t_dim, "max_abs_err": err}
            line = (f"K8 B={n_b} {name:14s} {ms:8.3f} ms {ms * 1e3 / t_dim:7.3f} us/step, "
                    f"max_abs_err {err:.4g}{'' if right else ' (results wrong by design)'}")
            if name == "stamps":
                buf = (ctypes.c_longlong * (160 * 8))()
                lib.probe_stamps_read(buf)
                st = torch.tensor(list(buf), dtype=torch.float64).view(160, 8)[:plan.ctas, :7]
                st /= t_dim
                row["cycles_per_step_mean"] = dict(zip(K8_STEP_PARTS, st.mean(0).tolist()))
                row["cycles_per_step_max"] = dict(zip(K8_STEP_PARTS, st.max(0).values.tolist()))
                line += "\n  cycles a step, mean over CTAs (max): " + ", ".join(
                    f"{k} {m:.0f} ({x:.0f})" for k, m, x in zip(
                        K8_STEP_PARTS, st.mean(0).tolist(), st.max(0).values.tolist()))
            log(line)
            out[f"B={n_b} {name}"] = row
    return out


# K1's parts of a step, each summed over the step's passes
K1_STEP_PARTS = ("next pass's xp", "h copies issued", "chunk waits", "chunk copies issued",
                 "product", "partial sums stored", "epilogue", "barrier arrival",
                 "next step's xp", "barrier wait")
K1_STAMPS = sub(
    ("namespace persist {\n",
     "namespace persist {\n__device__ long long probe_stamps[160 * 10];\n"
     "#define STAMP(i) { const unsigned n_ = static_cast<unsigned>(clock64()); "
     "acc_[i] += n_ - mark_; mark_ = n_; }\n"),
    ("  for (int s = 0; s < a.n_t; ++s) {\n",
     "  unsigned mark_ = static_cast<unsigned>(clock64());\n  unsigned acc_[10] = {};\n"
     "  for (int s = 0; s < a.n_t; ++s) {\n"),
    ("      if (pass > 0) cta.prefetch(t, b0, nb, n_chunks);\n",
     "      if (pass > 0) cta.prefetch(t, b0, nb, n_chunks);\n      STAMP(0)\n"),
    ("      acc.zero();\n", "      STAMP(1)\n      acc.zero();\n"),
    ("chunk c - 1 is read by all\n", "chunk c - 1 is read by all\n        STAMP(2)\n"),
    ("        sm::cp_async_commit();\n        if (has_item) acc.chunk(",
     "        sm::cp_async_commit();\n        STAMP(3)\n        if (has_item) acc.chunk("),
    ("tile, split);\n      }\n      sm::cp_async_wait<0>();\n",
     "tile, split);\n        STAMP(4)\n      }\n      sm::cp_async_wait<0>();\n"),
    ("      __syncthreads();\n\n      // the epilogue",
     "      __syncthreads();\n      STAMP(5)\n\n      // the epilogue"),
    ("      }\n      __syncthreads();\n    }\n",
     "      }\n      __syncthreads();\n      STAMP(6)\n    }\n"),
    ("      grid::barrier_arrive(a.counters + cta.d);\n",
     "      grid::barrier_arrive(a.counters + cta.d);\n      STAMP(7)\n"),
    ("      cta.prefetch(time_of(s + 1, a.n_t, rev), 0, min(l.rows, a.n_b), n_chunks);\n",
     "      cta.prefetch(time_of(s + 1, a.n_t, rev), 0, min(l.rows, a.n_b), n_chunks);\n"
     "      STAMP(8)\n"),
    ("      grid::barrier_wait(a.counters + cta.d, (s + 1) * a.plan.ctas);\n",
     "      grid::barrier_wait(a.counters + cta.d, (s + 1) * a.plan.ctas);\n      STAMP(9)\n"),
    ("  if (S == 2) {   // c leaves",
     "  if (threadIdx.x == 0)\n    for (int i_ = 0; i_ < 10; ++i_)\n"
     "      probe_stamps[(blockIdx.y * gridDim.x + blockIdx.x) * 10 + i_] = acc_[i_];\n"
     "  if (S == 2) {   // c leaves"))
K1_STAMP_READER = ('\nextern "C" int probe_stamps_read(long long* out) {\n  return '
                   'cudaMemcpyFromSymbol(out, dsjax_torch::persist::probe_stamps, '
                   'sizeof(long long) * 160 * 10);\n}\n')
K1_VARIANTS = {
    "as is": (sub(), True),
    "no_product": (sub(("        if (has_item) acc.chunk(", "        if (a.n_t < 0) acc.chunk(")),
                   False),
    "no_barrier": (sub(("      grid::barrier_wait(a.counters + cta.d, (s + 1) * a.plan.ctas);\n",
                        "      __syncthreads();\n")), False),
    "stamps": (K1_STAMPS, True),
}


def probe_k1(torch, log):
    from dsjax_torch.ops import _card, lstm

    libs = build("lstm_fwd.cu", K1_VARIANTS, "k1", header="scan_persist.cuh")
    p, i = ctypes.c_void_p, ctypes.c_int
    gen = torch.Generator().manual_seed(0)
    n_h, n_dir = 1024, 2
    out = {}
    for n_t, n_b in ((577, 20), (501, 8)):
        lengths = torch.randint(100, n_t + 1, (n_b,), generator=gen)
        lengths[0] = n_t
        mask = (torch.arange(n_t)[:, None] < lengths[None, :]).float().cuda()
        xp = (torch.randn(n_dir, n_t, n_b, 4 * n_h, generator=gen) * 0.3).cuda()
        w = (torch.randn(n_dir, 4 * n_h, n_h, generator=gen) * 0.03).cuda()
        b = (torch.randn(n_dir, 4 * n_h, generator=gen) * 0.1).cuda()
        h0, c0 = ((torch.randn(n_dir, n_b, n_h, generator=gen) * 0.1).cuda() for _ in range(2))
        rev = (False, True)
        want = lstm.lstm_scan_reference(xp, mask, w, b, h0, c0, rev)
        plan = lstm.scan_plan(n_dir, n_h, 4, torch.float32, n_b, _card.sm_count(xp.device))
        log(f"K1 T={n_t} B={n_b} f32 plan {plan}")
        for name, (_, right) in K1_VARIANTS.items():
            lib = libs[name]
            lib.dsjax_torch_lstm_fwd.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p,
                                                 p, p]

            def run():
                h = torch.empty((2, n_dir, n_b, n_h), device="cuda")
                c = torch.empty_like(h)
                h[0].copy_(h0)
                c[0].copy_(c0)
                y = torch.empty((n_dir, n_t, n_b, n_h), device="cuda")
                counters = torch.zeros(n_dir, dtype=torch.int32, device="cuda")
                err = lib.dsjax_torch_lstm_fwd(
                    xp.data_ptr(), mask.data_ptr(), w.data_ptr(), b.data_ptr(), h.data_ptr(),
                    c.data_ptr(), y.data_ptr(), None, None, n_dir, n_t, n_b, n_h, 2, 0,
                    torch.cuda.current_stream().cuda_stream, _card.plan_array(plan),
                    counters.data_ptr())
                if err:
                    raise SystemExit(f"torch_kernel_probe: K1 {name} returned {err}")
                return y, h[n_t % 2], c[n_t % 2]

            ms = median_ms(torch, run)
            got = run()
            torch.cuda.synchronize()
            err = max((g - e).abs().max().item() for g, e in zip(got, want))
            row = {"ms": ms, "us_per_step": ms * 1e3 / n_t, "max_abs_err": err}
            line = (f"K1 T={n_t} B={n_b} {name:12s} {ms:8.3f} ms {ms * 1e3 / n_t:7.3f} us/step, "
                    f"max_abs_err {err:.4g}{'' if right else ' (results wrong by design)'}")
            if name == "stamps":
                buf = (ctypes.c_longlong * (160 * 10))()
                lib.probe_stamps_read(buf)
                ctas = n_dir * plan.ctas
                st = torch.tensor(list(buf), dtype=torch.float64).view(160, 10)[:ctas]
                st /= n_t
                row["cycles_per_step_mean"] = dict(zip(K1_STEP_PARTS, st.mean(0).tolist()))
                row["cycles_per_step_max"] = dict(zip(K1_STEP_PARTS, st.max(0).values.tolist()))
                line += (f"\n  cycles a step, mean over CTAs (max), {st.sum(1).mean():.0f} in "
                         "all: " + ", ".join(
                             f"{k} {m:.0f} ({x:.0f})" for k, m, x in zip(
                                 K1_STEP_PARTS, st.mean(0).tolist(), st.max(0).values.tolist())))
            log(line)
            out[f"T={n_t} B={n_b} {name}"] = row
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", default="k8,k1", help="which probes to run, in order")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card.splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    probes = {"k8": probe_k8, "k1": probe_k1}
    result = {"card": card}
    for name in args.kernels.split(","):
        result[name] = probes[name](torch, print)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
