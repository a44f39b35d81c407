"""The ResNet-152 I-frame cell (`test.r152.iframe25x10`, runner
`video_test`) on the CPU at a small size: every piece found by name, the
plain reference against the port, the bf16 control and planted faults in
the timed path not `correct`, the operation count, and the kernel names
`conv_pct.test` counts as convolutions."""

import pytest
import torch
import torch.nn.functional as F

from conftest import merged

CELL = "test.r152.iframe25x10"
METRICS = ("mfu_pct.test", "idle_pct.test", "backbone_ms.test",
           "conv_pct.test")
# published widths and depth; 2 segments x 10 crops of 64x64 from 72x96
SMALL_CFG = {"input_size": 64, "scale_size": 64 * 256 // 224,
             "frame": {"height": 72, "width": 96, "channels": 8}}
SMALL_TRAFFIC = {"pool": 2, "segments": 2, "check_videos": 2}


def small_cell():
    from benchmark import harness, traffic

    manifest = harness.load_manifest()
    wl = harness.find(manifest["workloads"], CELL, "workload")
    cfg = merged(harness.load_config(manifest, wl["config"]), SMALL_CFG)
    return manifest, wl, cfg, {**traffic.load(wl["traffic"]),
                               **SMALL_TRAFFIC}


def run_small(seed=2**31 + 5, trace=0, control=None):
    from benchmark import harness

    manifest, wl, cfg, tr = small_cell()
    return harness.run_cell(manifest, wl, seed, 0.3, trace, "cpu", 0.0,
                            cfg=cfg, tr=tr, control=control)


def test_found_by_name():
    from benchmark import harness

    manifest, wl, cfg, tr = small_cell()
    assert (wl["config"], wl["chips"], tr["runner"]) == (
        "coviar_iframe_r152", 1, "video_test")
    assert cfg["reduced"] == [] and cfg["stage_sizes"] == [3, 8, 36, 3]
    assert set(cfg["modes"]["video_test"]["limits"]) == {"logit_gap"}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert e2e["eval_videos_per_s"]["workloads"] == ["eval.i3d.clip250",
                                                     CELL]
    per_layer = {m["name"]: m for m in manifest["per_layer"]}
    for name in METRICS:
        assert per_layer[name]["workloads"] == [CELL]
        assert per_layer[name]["moves"] == "eval_videos_per_s"
        assert callable(harness.load_reader(name))


def test_the_reference_matches_the_port():
    """Float32 on the CPU on both sides: the port's one-pass resampler
    against the reference's resize then crop, 50 blocks deep."""
    r = run_small()
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert r["readings"]["logit_gap"] < 1e-4
    assert r["readings"]["clip_gap"] < 1e-3


def test_the_control_is_not_correct():
    from benchmark.control import control_precision

    _, _, cfg, tr = small_cell()
    assert control_precision(cfg, tr["runner"]) == "bf16"
    r = run_small(control="bf16")
    assert r["correct"], r["checks"]
    c = r["control"]
    assert not c["correct"], c["checks"]
    assert c["checks"]["logit_gap"]["value"] > \
        c["checks"]["logit_gap"]["limit"]


def resnet_v1_stride(monkeypatch):
    """ResNet v1 against v1.5: a stage's first block strides on its first
    1x1 conv instead of the 3x3."""
    from dmcnet_tpu_torch.models import resnet

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = F.conv2d(x, self.conv1.weight, stride=self.conv2.stride)
        y = self.relu(self.bn1(y))
        y = self.relu(self.bn2(F.conv2d(y, self.conv2.weight, padding=1)))
        return self.relu(self.bn3(self.conv3(y)) + identity)

    monkeypatch.setattr(resnet.Bottleneck, "forward", forward)


def dropped_flip(monkeypatch):
    """The first corner's mirrored crop scored unmirrored."""
    from dmcnet_tpu_torch.cli import test as test_cli

    real = test_cli.augment_eval_batch

    def fault(raw, **kw):
        raw = dict(raw, flips=raw["flips"].copy())
        raw["flips"][:, 1] = False
        return real(raw, **kw)

    monkeypatch.setattr(test_cli, "augment_eval_batch", fault)


def one_crop_consensus(monkeypatch):
    """The video's score is the mean of its first crop's clips, the
    segments of one crop (25 of 250 at the cell's size)."""
    from dmcnet_tpu_torch.cli import test as test_cli

    real = test_cli.segment_consensus

    def fault(logits, n):
        return real(logits[:n // 10], n // 10)

    monkeypatch.setattr(test_cli, "segment_consensus", fault)


FAULTS = [resnet_v1_stride, dropped_flip, one_crop_consensus]


@pytest.mark.parametrize("plant", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_a_planted_fault_is_not_correct(plant, monkeypatch):
    plant(monkeypatch)
    r = run_small()
    assert not r["correct"], r["readings"]


def test_a_traced_run_reads_the_operations():
    """On the CPU the trace holds no device work: of the new metrics only
    the share of the peak reads, from the counted operations."""
    r = run_small(trace=1)
    assert r["correct"]
    assert set(r["metrics"]) == {"mfu_pct.test"}


def test_operation_count():
    """2 x multiply-adds from the shapes: 23.02 GFLOP a 224x224 clip,
    within 1% of torchvision's 11.51 GMAC for ResNet-152 (the 51-class
    head and the 3-channel stem move it by less), 5.756 TFLOP a video of
    250 clips."""
    from benchmark import harness
    from benchmark.reference import coviar
    from benchmark.yardstick import flops, meta_state

    manifest = harness.load_manifest()
    cfg = harness.load_config(manifest, "coviar_iframe_r152")
    n = flops(lambda: coviar.clip_logits(
        meta_state(coviar.shapes(cfg)), cfg,
        torch.empty(25, 256, 340, 8, dtype=torch.uint8, device="meta")))
    assert n / 1e9 == pytest.approx(5755.8415, rel=1e-6)
    assert n / 250 / 2e9 == pytest.approx(11.51, rel=0.01)


# kernel names from the ledger's breakdowns and this cell's traced windows
# (NVIDIA H100 80GB HBM3)
CONV_KERNELS = [
    "sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128x32_warpgroupsize"
    "1x1x1_execute_segment_k_off_kernel__5x_cublas",
    "void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_128x128_32x3_nn_"
    "align4>(cutlass_80_tensorop_s1688gemm_128x128_32x3_nn_align4::Params)",
    "sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc_tilesize"
    "128x128x32_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__5x_cudnn",
    "sm80_xmma_fprop_implicit_gemm_tf32f32_tf32f32_f32_nhwckrsc_nchw_"
    "tilesize256x64x32_stage3_warpsize4x2x1_g1_tensor16x8x8_execute_kernel__"
    "5x_cudnn",
    "sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc_t",
    "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_ti",
    "sm80_xmma_fprop_implicit_gemm_indexed_wo_smem_tf32f32_tf32f32_f3",
    "void_cutlass__5x_cudnn::Kernel_cutlass_tensorop_bf16_s16816fprop",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
    "void_precomputed_convolve_sgemm___nv_bfloat16__128__5__5__3__3__",
]
OTHER_KERNELS = [
    "void cudnn::bn_fw_inf_1C11_kernel_NCHW<float, float, true, 1>(float, "
    "float, cudnnTensorStruct, float const*, cudnnTensorStruct, float*, "
    "cudnnTensorStr",
    "void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous"
    " namespace)::launch_clamp_scalar(at::TensorIteratorBase&, c10::Scalar, "
    "c10::Sc",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "CUDAFunctor_add<float>, std::array<char*, 3ul> >(int, at::native::"
    "CUDAFunctor_add<float>",
    "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_stage3_warpsize"
    "1x4x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas",
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>("
    "cutlass_80_simt_sgemm_256x128_8x4_nn_align1::Params)",
    "void at::native::(anonymous namespace)::max_pool_forward_nchw<float, "
    "int>(int, float const*, long, long, long, int, int, int, int, int, int,",
    "Memcpy HtoD (Pageable -> Device)",
    "Memcpy_HtoD__Pageable_-__Device_",
    "void_cudnn::engines_precompiled::nchwToNhwcKernel___nv_bfloat16_",
    "void_cudnn::engines_precompiled::nhwcToNchwKernel_float__float__",
    "void_at::native::_anonymous_namespace_::CatArrayBatchedCopy_vect",
    "void_at::native::elementwise_kernel_128__4__at::native::gpu_kern",
    "void_at::native::_anonymous_namespace_::max_pool3d_with_indices_",
    "void_cudnn::bn_fw_inf_1C11_kernel_NCHW_float__float__true__1__fl",
    "void_cutlass::Kernel2_cutlass_80_simt_sgemm_256x128_8x4_nn_align",
]


def test_conv_kernels_are_told_apart_by_name():
    from benchmark import harness

    is_conv = harness.load_reader("conv_pct.test").__globals__["is_conv"]
    assert all(is_conv(n) for n in CONV_KERNELS)
    assert not any(is_conv(n) for n in OTHER_KERNELS)
