"""The kernels' files (``portbench/kernels/``) give what the harness's
closed lists gave before them: the same launch counters, kernel groups,
calls a layer and bounds, and so every per-layer reader the same value on
one fixed trace with today's kernel names. The lists as they stood are kept
below, word for word, as the "before"."""

import json
from pathlib import Path

import pytest

from portbench import counts, harness, kernels, run

ROOT = Path(__file__).resolve().parents[2]

# --- before: counts.py's and harness.py's closed lists -------------------

_GATES = {"lstm": 4, "gru": 3, "rnn": 1}
_SCAN_KERNELS = {("lstm", True): ("K2", "K3"), ("lstm", False): ("K1",),
                 ("gru", True): ("K4r", "K5"), ("gru", False): ("K4",),
                 ("rnn", True): (), ("rnn", False): ()}
_ESIZE = {"float32": 4, "bfloat16": 2}


def _before_counters():
    from dsjax_torch.ops import beam, gru, lstm

    return {"K1": lstm.LAUNCHES, "K2": lstm.RESIDUAL_LAUNCHES, "K3": lstm.BWD_LAUNCHES,
            "K4": gru.LAUNCHES, "K4r": gru.RESIDUAL_LAUNCHES, "K5": gru.BWD_LAUNCHES,
            "K7": beam.LAUNCHES, "backtrack": beam.BACKTRACK_LAUNCHES}


def _before_kernel_group(name):
    low = name.lower()
    for pattern, group in (("lstm_bwd_step_kernel", "K3"), ("gru_bwd_step_kernel", "K5"),
                           ("lstm_residual_step_kernel", "K2"),
                           ("gru_residual_step_kernel", "K4r"), ("beam_kernel", "K7"),
                           ("backtrack_kernel", "backtrack")):
        if pattern in low:
            return group
    if "persistent_scan" in low:
        return "K4" if "grucell" in low else "K1"
    if "nccl" in low:
        return "nccl"
    if "ctc" in low:
        return "ctc"
    if "multi_tensor_apply" in low or "adam" in low:
        return "optimizer"
    if "conv" in low or "fprop" in low or "dgrad" in low or "wgrad" in low:
        return "convolution"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet", "splitk")):
        return "matrix product"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "other"


def _before_scan_bound(kernel, n_dir, n_t, n_b, n_h, dtype, valid):
    e = _ESIZE[dtype]
    seq = n_dir * n_t * n_b * n_h
    state = n_dir * n_b * n_h
    mask = n_t * n_b * 4
    if kernel in ("K1", "K2", "K3"):
        g = 4
        w = n_dir * g * n_h * n_h * e
        if kernel == "K3":
            n_bytes = mask + w + e * (g * seq + state + seq + seq + 2 * state
                                      + g * seq + 2 * state)
        else:
            n_bytes = mask + w + e * (g * seq + n_dir * g * n_h + 2 * state + seq + 2 * state)
            if kernel == "K2":
                n_bytes += e * (g * seq + seq)
    elif kernel in ("K4", "K4r", "K5"):
        g = 3
        w = n_dir * g * n_h * n_h * e
        if kernel == "K5":
            n_bytes = mask + w + e * (4 * seq + seq + seq + state + g * seq + state)
        else:
            n_bytes = mask + w + e * (g * seq + n_dir * g * n_h + state + seq + state)
            if kernel == "K4r":
                n_bytes += e * 4 * seq
    else:
        raise KeyError(kernel)
    flops = 2.0 * g * n_h * n_h * valid * n_dir
    return counts.least_time(flops, n_bytes, dtype)


def _before_beam_bound(n_b, n_t, width, classes, valid_frames):
    bw = n_b * width
    n_bytes = (n_b * n_t * classes * 4 + n_b * 4 + 4 * n_t * bw * 4 + bw * 4
               + (2 * 4 + 5 * 4) * bw + bw * 4 + bw * 4)
    return counts.least_time(float(valid_frames) * width * classes, n_bytes, "float32")


def _before_bound(kernel, *call):
    return _before_beam_bound(*call) if kernel == "K7" else _before_scan_bound(kernel, *call)


# --- today's device kernel names, as the profiler gives them -------------

NAMES = [
    "void (anonymous namespace)::lstm_residual_step_kernel<__nv_bfloat16, true>(Params)",
    "void (anonymous namespace)::resident::lstm_bwd_step_kernel_resident<8, 20, false>(Args)",
    "void (anonymous namespace)::lstm_bwd_step_kernel<float>(Params)",
    "void dsjax_torch::persist::persistent_scan<float, (anonymous namespace)::LstmCell, "
    "true>(dsjax_torch::persist::Args<float>)",
    "void dsjax_torch::persist::persistent_scan<__nv_bfloat16, (anonymous namespace)::GruCell, "
    "false>(dsjax_torch::persist::Args<__nv_bfloat16>)",
    "void (anonymous namespace)::gru_residual_step_kernel<__nv_bfloat16>(Params)",
    "void (anonymous namespace)::gru_bwd_step_kernel<__nv_bfloat16>(Params)",
    "(anonymous namespace)::beam_kernel((anonymous namespace)::Params)",
    "(anonymous namespace)::backtrack_kernel(int const*, int const*, int*, short*, int, int)",
    "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
    "void at::native::(anonymous namespace)::ctc_loss_backward_collect_gpu_kernel<float, long>",
    "void at::native::(anonymous namespace)::multi_tensor_apply_kernel<TensorListMetadata<4>>",
    "sm80_xmma_wgrad_implicit_gemm_indexed_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128",
    "void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816dgrad_optimized_bf16_128x128>",
    "sm80_xmma_fprop_implicit_gemm_indexed_wo_smem_tf32f32_tf32f32_f32_nhwckrsc_nchw",
    "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NTT",
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x256_8x4_nt_align1>(Params)",
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_warpsize2x2x1_ffma",
    "Memcpy HtoD (Pinned -> Device)",
    "Memset (Device)",
    "void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl<AddFunctor>>",
    "void at::native::vectorized_elementwise_kernel<4, at::native::BinaryFunctor<float>>",
    "void cudnn::engines_precompiled::nchwToNhwcKernel<float, float, float, false, true>",
    "void mm_chain_kernel(Args)",
    "void dsjax_torch::radix_select_kernel<float>(Params)",
]


@pytest.mark.parametrize("name", NAMES)
def test_each_kernel_name_keeps_its_group(name):
    assert harness.kernel_group(name) == _before_kernel_group(name)


def test_every_kernel_file_is_found_and_matches_its_own_kernel():
    assert sorted(kernels.found()) == sorted(["K1", "K2", "K3", "K4", "K4r", "K5", "K7",
                                              "backtrack"])
    hit = {kernels.kernel_of(n) for n in NAMES} - {None}
    assert hit == set(kernels.found())


def test_a_name_two_files_match_raises():
    with pytest.raises(ValueError, match="matches the files"):
        kernels.kernel_of("lstm_bwd_step_kernel and gru_bwd_step_kernel")


def test_counters_name_the_same_attributes(monkeypatch):
    from dsjax_torch.ops import beam, gru, lstm

    for i, (module, attr) in enumerate([(lstm, "LAUNCHES"), (lstm, "RESIDUAL_LAUNCHES"),
                                        (lstm, "BWD_LAUNCHES"), (gru, "LAUNCHES"),
                                        (gru, "RESIDUAL_LAUNCHES"), (gru, "BWD_LAUNCHES"),
                                        (beam, "LAUNCHES"), (beam, "BACKTRACK_LAUNCHES")]):
        monkeypatch.setattr(module, attr, 100 + 7 * i)
    assert harness.counters() == _before_counters()


def test_layer_calls_launch_the_same_kernels():
    new = kernels.scan_kernels()
    for key, names in _SCAN_KERNELS.items():
        assert new.get(key, ()) == names, key
    assert set(new) <= set(_SCAN_KERNELS)


CALLS = [(d, t, b, h, dtype, valid) for d in (1, 2) for t, b, valid in
         ((512, 64, 512 * 64), (501, 8, 2317), (577, 20, 1), (0, 4, 0))
         for h in (64, 1024) for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4", "K4r", "K5"])
def test_scan_bounds_are_the_same(kernel):
    for call in CALLS:
        assert counts.bound(kernel, *call) == _before_bound(kernel, *call), call


def test_beam_bound_is_the_same():
    for call in ((16, 500, 128, 29, 16 * 500), (20, 577, 10, 29, 9000), (1, 1, 1, 29, 1)):
        assert counts.bound("K7", *call) == _before_bound("K7", *call)


def test_model_flops_and_gates_are_the_same():
    from portbench.reference import cells

    for kind in ("lstm", "gru"):
        assert cells.find(kind).GATES == _GATES[kind]
    with pytest.raises(KeyError, match="no reference cell"):
        cells.find("no_such_cell")


def _layer(training):
    """A fixed traced span: every name above, with counters and calls that
    agree for the span's scan and beam kernels."""
    arch = json.loads((ROOT / "portbench" / "configs" / "ds2-bilstm-1024x5.json").read_text())
    ops = {n: [3 + i, 0.0013 * (i + 1) + 1e-4 * i * i] for i, n in enumerate(NAMES)}
    dtype = "bfloat16" if training else "float32"
    if training:
        calls = {k: c * 3 for k, c in counts.scan_calls(arch, True, 512, 64, dtype,
                                                         512 * 64).items()}
    else:
        calls = {k: c * 20 for k, c in counts.scan_calls(arch, False, 577, 20, dtype,
                                                          9000).items()}
        calls["K7"] = [(20, 577, 10, 29, 9000)] * 20
    span = {"seconds": 0.61, "busy_s": 0.57, "ops": ops, "gaps": {"no host event": 0.002},
            "steps": 3, "batches": 20}
    window = {"seconds": 25.3, "steps": 140, "batches": 300, "decode_s": 21.0,
              "dtype": dtype, "flops": 4.2e16}
    return {"window": window, "span": span, "calls": calls,
            "counters": {k: len(v) for k, v in calls.items()}}


@pytest.mark.parametrize("training", [True, False])
def test_every_reader_reads_the_same(monkeypatch, training):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    moves = {m["moves"] for m in bench["per_layer"]}
    workload = "train-bilstm-b64-t1024" if training else "eval-bilstm-beam10-b20"
    layer = _layer(training)
    after = run.per_layer(bench, workload, dict.fromkeys(moves), layer, run.ROOT)
    monkeypatch.setattr(harness, "kernel_group", _before_kernel_group)
    monkeypatch.setattr(counts, "bound", _before_bound)
    before = run.per_layer(bench, workload, dict.fromkeys(moves), layer, run.ROOT)
    assert after == before
    rooflines = {k for k in after if k.endswith("_roofline")}
    assert rooflines == ({"K2_roofline", "K3_roofline"} if training
                         else {"K1_roofline", "K7_roofline"})
