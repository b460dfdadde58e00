"""Where a tensor-core kernel's time goes, by taking parts of it out.

    python -m amodal_depth_anything_tpu_torch.tools.kernel_ablation

Needs one NVIDIA Hopper card and nvcc. Copies `csrc/` into
`build/kernel_ablation/`, and for each ablation below edits the copy of one
source (every edit must find its text, so a source that has moved on fails
loudly), rebuilds that library and times it at the main paths' shapes in
bfloat16. The results of an ablated kernel are wrong on purpose: only its
time is read. The sources in the package are never touched.

What the ablations say:
  flash_attn_fwd  no_softmax: the two products, the loads and the barriers;
                  no_exp: the softmax with a multiply-add in place of each
                  exponential (the FP32 work without the MUFU unit);
                  no_products: the softmax path alone.
  fused_epilogue  product_only: no residual load, no epilogue arithmetic,
                  no store; epilogue_only: one k tile per output tile.
A part that is hidden behind another costs nothing when it is taken out.
"""

from __future__ import annotations

import shutil
import subprocess
import sys

ATTN_SHAPES = [(4, 24, 1370, 64), (1, 24, 5330, 64), (4, 8, 4096, 40)]
GEMM_SHAPES = [(42640, 1536, 1536), (42640, 1024, 1024), (5480, 4096, 1536)]

# library -> {ablation: [(text in the source, its replacement), ...]}
ABLATIONS = {
    "flash_attn_fwd": {
        "full": [],
        "no_softmax": [(
            "      softmax_tile(s, m, l, alpha, scale_log2, t * kWgRows + "
            "col0,\n                   (t + 1) * kWgRows, kv_len);\n",
            "      alpha[0] = alpha[1] = 1.f; l[0] += s[0]; l[1] += s[2];\n")],
        "no_exp": [(
            'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
            "y = x * 0.001f + 1.f;")],
        "no_products": [
            ("        wgmma_ss<0>(s, wgmma_desc_advance(dq, kk * 32),\n"
             "                    wgmma_desc_advance(dk, kk * 32), kk != 0);\n",
             "        s[kk] = __uint_as_float((uint32_t)(dq + dk) & "
             "0x3fffffffu);\n"),
            ("        wgmma_rs(acc, pf[kk], wgmma_desc_advance(dv, kk * 16 * "
             "kSwizzleRow));\n",
             "        acc[kk] += __uint_as_float(pf[kk][0] ^ (uint32_t)dv);\n")],
    },
    "fused_epilogue": {
        "full": [],
        "product_only": [
            ("            mbar_arrive_expect_tx(c_full, 2 * kCTile);\n"
             "            #pragma unroll\n"
             "            for (int c = 0; c < kBoxes; ++c)\n"
             "              tma_load_2d(cs + c * kBox, &map_resid, c_full, "
             "n0 + 64 * c, m0);\n",
             "            mbar_arrive(c_full);\n"),
            ("          tma_store_2d(&map_out, cs + c * kBox, n0 + 64 * c, "
             "m0);\n", "          ;\n"),
            ("          const float2 rv = __bfloat1622float2(*at);\n"
             "          *at = __floats2bfloat162_rn(\n"
             "              rv.x + gv.x * (acc[4 * j + 2 * r] + bv.x),\n"
             "              rv.y + gv.y * (acc[4 * j + 2 * r + 1] + bv.y));\n",
             "          if (acc[4 * j + 2 * r] == 123.456f && gv.x == bv.y)\n"
             "            *at = __floats2bfloat162_rn(1.f, 2.f);\n")],
        "epilogue_only": [(
            "  const int k_tiles = (k + kBK - 1) / kBK;\n"
            "  const int wg = threadIdx.x >> 7;\n\n  if (wg == 2) {\n"
            "    setmaxnreg_dec<40>();\n    if (threadIdx.x == 2 * 128) {\n"
            "      // ---",
            "  const int k_tiles = 1;\n"
            "  const int wg = threadIdx.x >> 7;\n\n  if (wg == 2) {\n"
            "    setmaxnreg_dec<40>();\n    if (threadIdx.x == 2 * 128) {\n"
            "      // ---")],
    },
}


def cuda_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    from ..ops import _build
    from ..ops.flash_attention import mha
    from ..ops.fused_epilogue import matmul_scale_residual

    if not torch.cuda.is_available():
        print("kernel_ablation: no CUDA device", file=sys.stderr)
        return 1
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    work = _build.BUILD_DIR.parent / "kernel_ablation"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(_build.CSRC, work / "csrc")
    sources = {name: (_build.CSRC / f"{name}.cu").read_text()
               for name in ABLATIONS}
    _build.CSRC, _build.BUILD_DIR = work / "csrc", work / "lib"

    gen = torch.Generator(device="cuda").manual_seed(0)
    qkvs = [torch.randn((b, n, 3, h, d), generator=gen, device="cuda",
                        dtype=torch.bfloat16) for b, h, n, d in ATTN_SHAPES]
    gemms = []
    for m, k, n in GEMM_SHAPES:
        x, r = (torch.randn((m, c), generator=gen, device="cuda")
                .bfloat16() for c in (k, n))
        w = (torch.randn((k, n), generator=gen, device="cuda")
             * 0.02).bfloat16()
        b, g = (torch.randn((n,), generator=gen, device="cuda")
                for _ in range(2))
        gemms.append((x, w, b, g, r))

    for name, ablations in ABLATIONS.items():
        for label, edits in ablations.items():
            text = sources[name]
            for old, new in edits:
                if old not in text:
                    raise SystemExit(f"{name}/{label}: the source no longer "
                                     f"holds {old[:60]!r}")
                text = text.replace(old, new)
            (_build.CSRC / f"{name}.cu").write_text(text)
            _build._loaded.clear()
            _build.build((name,))
            times = []
            if name == "flash_attn_fwd":
                for shape, qkv in zip(ATTN_SHAPES, qkvs):
                    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
                    times.append(f"{list(shape)} "
                                 f"{cuda_ms(lambda: mha(q, k, v)):.4f} ms")
            else:
                for shape, args in zip(GEMM_SHAPES, gemms):
                    ms = cuda_ms(lambda: matmul_scale_residual(*args))
                    times.append(f"{list(shape)} {ms:.4f} ms")
            print(f"{name} {label}: {'; '.join(times)} [{gpu}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
