"""Checkpoint-day verification kit, on the port's loaders.

Port of the JAX package's `scripts/verify_checkpoints.py`: given any subset
of the released weights, run the port's loaders (`convert/weights.py`,
`convert/heuristics.py`, `convert/zoedepth_convert.py`), forward smokes,
the full-chain gate and the quality gates (`pipeline/quality.py`) and
print a pass/fail table:

    # checkpoint day: drop everything in one directory and run
    python -m amodal_depth_anything_tpu_torch.scripts.verify_checkpoints \\
        --all work_dir/ckp --quality

    # rehearsal (no network): synthesize tiny checkpoints in the released
    # on-disk formats and run the same gate end to end
    python -m amodal_depth_anything_tpu_torch.scripts.verify_checkpoints \\
        --rehearse [DIR] [--skip_chain --size 126] [--device cpu]

    # or per-artifact flags
    ... --dav2_base amodal_depth_anything_base.pth \\
        --dav2_amodal model.safetensors [--depthfm depthfm-v1.ckpt] \\
        [--depthfm_vae vae.pth] [--sam sam_vit_h.pth] \\
        [--pix2gestalt epoch=000005.ckpt] [--rmbg rmbg14.pth] \\
        [--invisible_stitch invisible-stitch.pt] [--image IMG --mask MASK]

Rows per artifact: `*_convert` (the loader runs, strict, every tensor
finite, the file's element count against the module's), `*_forward` (a
small forward, finite output) for the DAV2 pair and the DepthFM UNet, the
DepthFM pipeline and, with `--quality`, the int8 / ToMe / DeepCache deltas
against the exact pipelines (`--gate_max_abs` turns them into gates), the
pix2gestalt CLIP-input and InvisibleStitch prep divergence guards, and the
<1e-3 full-chain gate against the reference's own inference (needs the
reference checkout and `tests/ref_golden_dump.py`).

`--rehearse` writes the artifacts from the port's own modules'
`state_dict()`s (seeded weights; the modules carry the reference key
names): `amodal_depth_anything_base.pth` (raw vits), `model.safetensors`
(AmodalDAv2 vits, through `convert/safetensors.py`), the LDM
`depthfm-v1.ckpt`, `vae.pth`, `sam_vit_h.pth`, `epoch=000005.ckpt`,
`rmbg14.pth` (BatchNorm unfolded) and `invisible-stitch.pt` (`model` +
`module.` wrapped), at the JAX kit's tiny converter configs, so the JAX
kit's converters read them too. Where neither `--image` nor the reference
asset exists, it writes a seeded image and mask beside them for the
quality rows. Rows whose inputs are absent print SKIP; the kit exits
non-zero only on FAIL.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import zlib

import numpy as np

__all__ = ["build_parser", "tiny_configs", "synthesize_rehearsal",
           "write_depthfm_artifacts",
           "zoedepth_reference_state_dict", "Report", "main"]

REFERENCE = "reference"   # a checkout of the reference code

CANONICAL = (
    # (args attr, filenames the reference ecosystem ships)
    ("dav2_base", ("amodal_depth_anything_base.pth",
                   "depth_anything_v2_vitg.pth")),
    ("dav2_amodal", ("model.safetensors",)),
    ("depthfm", ("depthfm-v1.ckpt",)),
    ("depthfm_vae", ("vae.pth", "sd-vae-ft-mse.pth",
                     "diffusion_pytorch_model.safetensors")),
    ("sam", ("sam_vit_h.pth", "sam_vit_h_4b8939.pth")),
    ("pix2gestalt", ("epoch=000005.ckpt",)),
    ("rmbg", ("rmbg14.pth", "rmbg-1.4.pth", "model.pth")),
    ("invisible_stitch", ("invisible-stitch.pt", "invisible_stitch.pt")),
)
REHEARSAL_IMAGE, REHEARSAL_MASK = "rehearsal_image.png", "rehearsal_mask.png"


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--all", default=None, metavar="DIR",
                   help="scan DIR for every canonically-named checkpoint "
                        "and verify all of them; --<name> flags override")
    p.add_argument("--rehearse", nargs="?", const="", default=None,
                   metavar="DIR",
                   help="synthesize tiny checkpoints in the on-disk formats "
                        "into DIR (or a temp dir) and run the whole gate "
                        "on them; implies --all, --quality and --tiny")
    p.add_argument("--tiny", action="store_true",
                   help="the tiny converter configs for the SAM / RMBG / "
                        "ZoeDepth / pix2gestalt rows (the rehearsal's)")
    p.add_argument("--dav2_base", default=None)
    p.add_argument("--dav2_amodal", default=None)
    p.add_argument("--depthfm", default=None)
    p.add_argument("--depthfm_vae", default=None,
                   help="diffusers SD-1.5 AutoencoderKL weights; with "
                        "--depthfm enables the pipeline rows")
    p.add_argument("--depthfm_size", type=int, default=512,
                   help="DepthFM pipeline resolution (multiple of 8)")
    p.add_argument("--sam", default=None)
    p.add_argument("--pix2gestalt", default=None)
    p.add_argument("--rmbg", default=None)
    p.add_argument("--invisible_stitch", default=None)
    p.add_argument("--image", default=None,
                   help="image for the chain / quality gates "
                        "(default: the reference asset)")
    p.add_argument("--mask", default=None)
    p.add_argument("--quality", action="store_true",
                   help="run the int8 / ToMe / DeepCache quality rows")
    p.add_argument("--gate_max_abs", type=float, default=None,
                   help="a quality row FAILs when its max-abs delta "
                        "exceeds this (checkpoint day: 0.05); default "
                        "report-only")
    p.add_argument("--tome_base", default=None,
                   help="'layer,r' for the base trunk (default: merge "
                        "half the tokens after the first tap)")
    p.add_argument("--tome_amodal", default=None)
    p.add_argument("--skip_forward", action="store_true",
                   help="converter rows only (no forwards)")
    p.add_argument("--skip_chain", action="store_true",
                   help="skip the (slow, 518 px) full-chain gate")
    p.add_argument("--size", type=int, default=518)
    p.add_argument("--reference", default=REFERENCE,
                   help="the reference code's checkout (its assets and "
                        "inference chain)")
    p.add_argument("--output", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")
    return p


def tiny_configs() -> dict:
    """The tiny converter configs of --rehearse / --tiny (the JAX kit's)."""
    from ..models.beit import BEiTConfig
    from ..models.pix2gestalt import Pix2GestaltConfig
    from ..models.rmbg import RMBGConfig
    from ..models.sam import SAMConfig
    from ..models.zoedepth import ZoeDepthConfig

    return {
        "sam": SAMConfig(img_size=64, embed_dim=32, depth=2, num_heads=2,
                         window_size=2, global_blocks=(1,), out_chans=32,
                         decoder_dim=32, decoder_heads=2),
        "rmbg": RMBGConfig(width=8, stage_mid=(4, 4, 4, 8, 8, 8),
                           stage_out=(8, 8, 16, 16, 16, 16),
                           dec_mid=(4, 4, 4, 8, 8)),
        "zoe": ZoeDepthConfig(
            backbone=BEiTConfig(embed_dim=64, depth=4, num_heads=2,
                                img_size=64, in_chans=5),
            hooks=(0, 1, 2, 3), tap_channels=(8, 16, 32, 32), features=16,
            n_bins=8, bin_embedding_dim=16, n_attractors=(4, 2, 2, 1),
            midas_out=8),
        "p2g": Pix2GestaltConfig(model_channels=32, channel_mult=(1, 2),
                                 num_heads=2, context_dim=32),
    }


# the port's InvisibleStitch names -> the reference's (the inverse of
# `convert/zoedepth_convert.py`'s rules)
_ZOE_TO_REFERENCE = (
    (r"^backbone\.", "core.core.pretrained.model."),
    (r"^readout\.(\d)\.",
     lambda m: f"core.core.pretrained.act_postprocess{int(m[1]) + 1}"
               f".0.project.0."),
    (r"^reassemble\.(\d)\.project\.",
     lambda m: f"core.core.pretrained.act_postprocess{int(m[1]) + 1}.3."),
    (r"^reassemble\.(\d)\.resize\.",
     lambda m: f"core.core.pretrained.act_postprocess{int(m[1]) + 1}.4."),
    (r"^scratch\.output_conv\.conv(\d)\.",
     lambda m: f"core.core.scratch.output_conv.{(int(m[1]) - 1) * 2}."),
    (r"^scratch\.", "core.core.scratch."),
    (r"^((?:seed_bin_regressor|seed_projector|projectors\.\d|"
     r"attractors\.\d))\.conv(\d)\.",
     lambda m: f"{m[1]}._net.{(int(m[2]) - 1) * 2}."),
    (r"^conditional_log_binomial\.conv(\d)\.",
     lambda m: f"conditional_log_binomial.mlp.{(int(m[1]) - 1) * 2}."),
)


def zoedepth_reference_state_dict(model) -> dict:
    """An InvisibleStitch module's state dict under the reference's names
    (`invisible-stitch.pt`'s `model` dict without the `module.` prefix)."""
    out = {}
    for key, v in model.state_dict().items():
        for pattern, repl in _ZOE_TO_REFERENCE:
            new = re.sub(pattern, repl, key)
            if new != key:
                key = new
                break
        out[key] = v.detach().clone()
    return out


def write_depthfm_artifacts(outdir: str, *, device="cpu", seed: int = 12
                            ) -> tuple[str, str]:
    """A seeded tiny plain DepthFM as the LDM `depthfm-v1.ckpt` dict
    (hparams, noising step, empty-text embedding) and its VAE as a
    diffusers-layout `vae.pth`; returns both paths."""
    import torch

    from ..models.depthfm import DepthFMConfig, build_depthfm, init_depthfm_

    dfm = init_depthfm_(build_depthfm(DepthFMConfig(
        guide_type="none", model_channels=32, channel_mult=(1, 2),
        num_heads=2, context_dim=32, context_len=7, vae_channels=(16, 32),
        vae_layers=1), device=device),
        torch.Generator(device=device).manual_seed(seed))
    paths = (os.path.join(outdir, "depthfm-v1.ckpt"),
             os.path.join(outdir, "vae.pth"))
    torch.save({
        "ldm_hparams": {"context_dim": 32, "model_channels": 32,
                        "channel_mult": [1, 2], "num_heads": 2},
        "noising_step": 400,
        "state_dict": {k: v.detach().cpu() for k, v in
                       dfm.unet.state_dict().items()},
        "empty_text_embedding": np.zeros((7, 32), np.float32),
    }, paths[0])
    torch.save({k: v.detach().cpu() for k, v in dfm.vae.state_dict().items()},
               paths[1])
    return paths


def synthesize_rehearsal(outdir: str, *, device="cpu") -> None:
    """Write tiny seeded checkpoints into `outdir` in the on-disk formats
    the reference ecosystem ships, from the port's modules' state dicts."""
    import torch

    from ..convert.safetensors import save_file
    from ..convert.zoedepth_convert import zoedepth_state_dict
    from ..heuristics.mask_heuristics import _empty, init_heuristics_
    from ..models.amodal_dav2 import DAV2Config, build_model, init_weights_
    from ..models.rmbg import ISNet
    from ..models.sam import SAM
    from ..models.unet_ldm import UNetModel
    from ..models.zoedepth import InvisibleStitch

    os.makedirs(outdir, exist_ok=True)
    tc = tiny_configs()

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    def cpu(sd):
        return {k: v.detach().cpu().contiguous() for k, v in sd.items()}

    # DAV2 raw base -> .pth (reference infer.py:59-60); AmodalDAv2 ->
    # HF model.safetensors
    raw = init_weights_(build_model(DAV2Config(
        encoder="vits", guide_type="none", raw=True), device=device),
        gen(10))
    torch.save(cpu(raw.state_dict()),
               os.path.join(outdir, "amodal_depth_anything_base.pth"))
    amodal = init_weights_(build_model(DAV2Config(
        encoder="vits", guide_type="mask+observation"), device=device),
        gen(11))
    save_file(cpu(amodal.state_dict()),
              os.path.join(outdir, "model.safetensors"))

    write_depthfm_artifacts(outdir, device=device)

    # SAM -> .pth (app.py:35 format)
    sam = init_heuristics_(_empty(SAM, tc["sam"], device=device), gen(14))
    torch.save(cpu(sam.state_dict()), os.path.join(outdir, "sam_vit_h.pth"))

    # pix2gestalt -> an LDM ckpt, the UNet under model.diffusion_model.
    unet = init_heuristics_(_empty(UNetModel, tc["p2g"].unet,
                                   device=device), gen(15))
    torch.save({"state_dict": {f"model.diffusion_model.{k}": v for k, v
                               in cpu(unet.state_dict()).items()}},
               os.path.join(outdir, "epoch=000005.ckpt"))

    # RMBG -> .pth with live BatchNorm statistics: each folded (scale,
    # shift) unfolded against a seeded running mean and variance
    rmbg = init_heuristics_(_empty(ISNet, tc["rmbg"], device=device),
                            gen(16))
    rng = np.random.default_rng(0)
    sd = {}
    for k, v in cpu(rmbg.state_dict()).items():
        head, sep, leaf = k.rpartition(".bn_s1.")
        if not sep:
            sd[k] = v
            continue
        if leaf == "shift":
            continue
        scale = v.numpy().astype(np.float64)
        shift = cpu(rmbg.state_dict())[f"{head}.bn_s1.shift"].numpy()
        mean = rng.normal(0.0, 0.1, scale.shape)
        var = rng.uniform(0.5, 1.5, scale.shape)
        p = f"{head}.bn_s1."
        sd[p + "weight"] = torch.from_numpy(
            (scale * np.sqrt(var + 1e-5)).astype(np.float32))
        sd[p + "bias"] = torch.from_numpy((shift + mean * scale)
                                          .astype(np.float32))
        sd[p + "running_mean"] = torch.from_numpy(mean.astype(np.float32))
        sd[p + "running_var"] = torch.from_numpy(var.astype(np.float32))
    torch.save(sd, os.path.join(outdir, "rmbg14.pth"))

    # InvisibleStitch -> .pt with the 'model' wrapper and module. prefix
    zoe = _empty(InvisibleStitch, tc["zoe"], device=device)
    zoe.init_weights_(gen(17))
    ref = zoedepth_reference_state_dict(zoe)
    back = zoedepth_state_dict(ref, zoe)
    assert all(torch.equal(back[k], v) for k, v in zoe.state_dict().items())
    torch.save({"model": {f"module.{k}": v.cpu() for k, v in ref.items()}},
               os.path.join(outdir, "invisible-stitch.pt"))


def _rehearsal_inputs(outdir: str) -> tuple[str, str]:
    """A seeded textured image and a box mask, as PNGs in `outdir`."""
    from ..utils.image import write_png
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:96, 0:128]
    img = np.stack([np.sin(xx / 9 + k) * 80 + np.cos(yy / 7 - k) * 40 + 128
                    for k in range(3)], -1) + rng.normal(0, 10, (96, 128, 3))
    mask = np.zeros((96, 128), np.uint8)
    mask[24:72, 32:90] = 255
    paths = (os.path.join(outdir, REHEARSAL_IMAGE),
             os.path.join(outdir, REHEARSAL_MASK))
    write_png(paths[0], np.clip(img, 0, 255).astype(np.uint8))
    write_png(paths[1], mask)
    return paths


def _numel(sd) -> int:
    return sum(int(np.prod(v.shape)) for v in sd.values())


def _finite(module) -> bool:
    import torch
    return all(bool(torch.isfinite(t).all()) for t in
               module.state_dict().values() if t.is_floating_point())


class Report:
    def __init__(self):
        self.rows = []

    def add(self, name, status, detail=""):
        self.rows.append((name, status, detail))
        print(f"{name:<32} {status:<6} {detail}", flush=True)

    @property
    def failed(self):
        return any(s == "FAIL" for _, s, _ in self.rows)

    def text(self):
        return "\n".join(f"{n:<32} {s:<6} {d}" for n, s, d in self.rows) \
            + "\n"


def _gate_detail(args, delta: dict) -> str:
    """The gate's note for a quality row; raises (a FAIL row) when
    --gate_max_abs is set and exceeded."""
    gate = args.gate_max_abs
    if gate is None:
        return ""
    from ..pipeline.quality import check_gate
    verdict = check_gate(delta, max_abs=gate, mean_abs=float("inf"))
    if not verdict["pass"]:
        raise AssertionError(f"quality gate FAIL: {verdict['failed']} "
                             f"exceed max_abs {gate}")
    return f" [gate<= {gate} OK]"


def _row(report, name, fn):
    try:
        detail = fn()
        report.add(name, "PASS", detail or "")
    except Exception as e:  # noqa: BLE001 - the table is the error report
        report.add(name, "FAIL", f"{type(e).__name__}: {e}")


def _load(path):
    import torch
    return torch.load(path, map_location="cpu", weights_only=False)


def _image_and_mask(args):
    """(BGR image as cv2.imread reads it, float mask) of --image / --mask
    or the reference asset; None where there is none."""
    from ..utils.image import read_image, read_image_bgr
    img = args.image or \
        f"{args.reference}/assets/inference_examples/case1.jpg"
    msk = args.mask or \
        f"{args.reference}/assets/inference_masks/case1_mask.png"
    if not (os.path.exists(img) and os.path.exists(msk)):
        return None
    mask = (read_image(msk) > 0).astype(np.float32)
    if mask.ndim == 3:
        mask = mask[..., 0]
    return read_image_bgr(img), mask, img, msk


def check_dav2(report, path, *, raw, skip_forward, device):
    import torch

    from ..convert.weights import infer_dav2_config, load_state_dict
    from ..models.amodal_dav2 import build_model

    name = "dav2_base" if raw else "dav2_amodal"
    holder = {}

    def _convert():
        sd = load_state_dict(path)
        cfg = infer_dav2_config(sd)
        model = build_model(cfg, device=device)
        model.load_state_dict(sd, strict=True)
        assert _finite(model), "non-finite parameters"
        n_file, n_model = _numel(sd), _numel(model.state_dict())
        assert n_file == n_model, \
            f"element count drift: file {n_file} vs module {n_model}"
        holder["model"] = model.eval()
        return f"{cfg.encoder}{' raw' if cfg.raw else ''} {n_file / 1e6:.1f}M"

    _row(report, f"{name}_convert", _convert)
    if skip_forward or "model" not in holder:
        return

    def _forward():
        model = holder["model"]
        x = torch.from_numpy(np.random.default_rng(0).random(
            (1, 56, 56, 3)).astype(np.float32)).to(device)
        with torch.no_grad():
            if raw:
                out = model(x)
            else:
                g = torch.ones(1, 56, 56, 1, device=device)
                out = model(x, guide_mask=g, observation=g * 0.5)
        out = out.float().cpu().numpy()
        assert np.isfinite(out).all(), "non-finite forward output"
        return f"out[{','.join(map(str, out.shape))}] ok"

    _row(report, f"{name}_forward", _forward)


def check_full_chain(report, args):
    """<1e-3 float gate against the reference's own inference chain."""
    import subprocess
    import tempfile

    dump_script = os.path.join(os.path.dirname(__file__), "..", "..",
                               "tests", "ref_golden_dump.py")
    if not os.path.exists(dump_script):
        report.add("full_chain_1e-3", "SKIP",
                   "tests/ref_golden_dump.py not found")
        return
    if not os.path.isdir(args.reference):
        report.add("full_chain_1e-3", "SKIP", "reference checkout absent")
        return
    inputs = _image_and_mask(args)
    if inputs is None:
        report.add("full_chain_1e-3", "SKIP", "no image available")
        return

    def _run():
        from ..pipeline import AmodalDepthPipeline
        from ..utils.host_image import resize_bilinear
        image, mask, img, msk = inputs
        env = dict(os.environ,
                   GOLDEN_RAW_CKPT=os.path.abspath(args.dav2_base),
                   GOLDEN_AMODAL_CKPT=os.path.abspath(args.dav2_amodal),
                   GOLDEN_IMAGE=os.path.abspath(img),
                   GOLDEN_MASK=os.path.abspath(msk))
        with tempfile.TemporaryDirectory() as td:
            out = os.path.join(td, "chain.npz")
            subprocess.run([sys.executable, dump_script, "infer_chain", out],
                           check=True, env=env, timeout=3600)
            data = dict(np.load(out))
        pipe = AmodalDepthPipeline.from_checkpoints(
            args.dav2_base, args.dav2_amodal, size=args.size,
            device=args.device)
        base, blended = pipe(image, mask, base_image=resize_bilinear(
            image, (args.size, args.size)))
        b = float(np.abs(base - data["base_float"]).max())
        a = float(np.abs(blended - data["blended_float"]).max())
        assert b < 1e-3, f"base max diff {b:.2e} >= 1e-3"
        assert a < 1e-3, f"blended max diff {a:.2e} >= 1e-3"
        return f"base {b:.2e}, blended {a:.2e}"

    _row(report, "full_chain_1e-3", _run)


def check_quality(report, args):
    """int8 / ToMe blended-depth deltas against the exact pipeline."""
    from ..pipeline import AmodalDepthPipeline
    from ..pipeline.quality import corpus_quality_report

    inputs = _image_and_mask(args)
    if inputs is None:
        report.add("quality", "SKIP", "no image available")
        return
    image, mask = inputs[:2]
    corpus = [{"image": image, "mask": mask}]

    def build(**kw):
        return AmodalDepthPipeline.from_checkpoints(
            args.dav2_base, args.dav2_amodal, size=args.size,
            device=args.device, **kw)

    exact = build()

    def run_exact(im, mk):
        return exact(im[0], mk[0, ..., 0])

    def _int8():
        q = build()
        q.quantize_int8(base=True, amodal=True, head=True,
                        calibration=(image, mask))
        o = corpus_quality_report(
            run_exact, lambda im, mk: q(im[0], mk[0, ..., 0]),
            corpus)["overall"]
        return (f"blended max {o['blended_max_abs']:.2e} "
                f"mean {o['blended_mean_abs']:.2e}" + _gate_detail(args, o))

    _row(report, "int8_quality_delta", _int8)

    def _tome():
        n_tokens = (args.size // 14) ** 2 + 1
        default_r = n_tokens // 2 - 1   # the largest legal merge
        first_tap = {"vits": 2, "vitb": 2, "vitl": 4, "vitg": 9,
                     "vitt": 0, "vitp": 2}

        def pair(spec, cfg):
            return tuple(int(v) for v in spec.split(",")) if spec else \
                (first_tap[cfg.encoder], default_r)

        bt = pair(args.tome_base, exact.raw_cfg)
        at = pair(args.tome_amodal, exact.amodal_cfg)
        t = build(base_token_merge=bt, amodal_token_merge=at)
        o = corpus_quality_report(
            run_exact, lambda im, mk: t(im[0], mk[0, ..., 0]),
            corpus)["overall"]
        return (f"base={bt} amodal={at}: blended max "
                f"{o['blended_max_abs']:.2e} mean {o['blended_mean_abs']:.2e}"
                + _gate_detail(args, o))

    _row(report, "tome_quality_delta", _tome)


def _depthfm_from_ckpt(path, device):
    """The UNet (and empty-text embedding) of a depthfm-v1.ckpt, built from
    its hparams and loaded strictly, with the file's tensors."""
    import torch

    from ..convert.weights import _depthfm_config_from_ckpt
    from ..models.unet_ldm import UNetModel

    ckpt = _load(path)
    cfg = _depthfm_config_from_ckpt(ckpt, "none")
    with torch.device("meta"):
        unet = UNetModel(cfg.unet)
    unet = unet.to_empty(device=device)
    sd = {k: torch.as_tensor(np.asarray(v)).float()
          for k, v in ckpt["state_dict"].items()}
    unet.load_state_dict(sd, strict=True)
    return cfg, unet.eval(), sd, ckpt


def check_depthfm(report, path, skip_forward, device):
    import torch
    holder = {}

    def _convert():
        cfg, unet, sd, _ = _depthfm_from_ckpt(path, device)
        assert _finite(unet), "non-finite parameters"
        holder["cfg"], holder["unet"] = cfg, unet
        return (f"unet {_numel(sd) / 1e6:.1f}M, "
                f"noising_step={cfg.noising_step}")

    _row(report, "depthfm_convert", _convert)
    if skip_forward or "cfg" not in holder:
        return

    def _forward():
        cfg, unet = holder["cfg"], holder["unet"]
        ucfg = cfg.unet
        x = torch.zeros(1, 16, 16, 4, device=device)
        ctx = torch.zeros(1, 16, 16, ucfg.in_channels - 4, device=device)
        ca = torch.zeros(1, cfg.context_len, cfg.context_dim, device=device)
        with torch.no_grad():
            out = unet(x, torch.ones(1, device=device), context=ctx,
                       context_ca=ca).float().cpu().numpy()
        assert np.isfinite(out).all(), "non-finite UNet output"
        return f"unet fwd out[{','.join(map(str, out.shape))}] ok"

    _row(report, "depthfm_unet_forward", _forward)


def check_depthfm_pipeline(report, args):
    """The guided DepthFM serving pipeline on the UNet ckpt + the VAE:
    a forward gate, and the int8 / ToMe / DeepCache deltas under
    --quality. The observation is a grey proxy of the image."""
    from ..pipeline import DepthFMPipeline

    inputs = _image_and_mask(args)
    if inputs is None:
        report.add("depthfm_pipeline_forward", "SKIP", "no image available")
        return
    image = np.ascontiguousarray(inputs[0][..., ::-1])   # RGB
    mask = inputs[1]
    obs = image.astype(np.float32).mean(axis=-1) / 255.0
    holder = {}

    def _forward():
        pipe = DepthFMPipeline.from_checkpoints(
            args.depthfm, args.depthfm_vae, size=args.depthfm_size,
            device=args.device)
        out = pipe(image, mask, obs)
        assert np.isfinite(out).all(), "non-finite depth"
        assert 0.0 <= out.min() and out.max() <= 1.0, "depth outside [0,1]"
        holder["pipe"], holder["exact"] = pipe, out
        return f"out [{out.shape[0]}x{out.shape[1]}] in [0,1]"

    _row(report, "depthfm_pipeline_forward", _forward)
    if not args.quality:
        return
    if "exact" not in holder:
        report.add("depthfm_int8_quality_delta", "SKIP", "forward failed")
        return
    exact = holder["exact"]

    def build(**kw):
        return DepthFMPipeline.from_checkpoints(
            args.depthfm, args.depthfm_vae, size=args.depthfm_size,
            device=args.device, **kw)

    def _delta(optimized):
        d = np.abs(optimized(image, mask, obs) - exact)
        stats = {"depth_max_abs": float(d.max()),
                 "depth_mean_abs": float(d.mean())}
        return (f"depth max {d.max():.2e} mean {d.mean():.2e}"
                + _gate_detail(args, stats))

    def _int8():
        q = build()
        q.quantize_int8()
        return _delta(q)

    _row(report, "depthfm_int8_quality_delta", _int8)
    _row(report, "depthfm_tome_quality_delta",
         lambda: _delta(build(tome=(0.75, 4096))))
    _row(report, "depthfm_deepcache_quality_delta",
         lambda: _delta(build(deep_cache=(2, 3))))


def check_sam(report, path, cfg, device):
    def _convert():
        from ..convert import heuristics as ch
        from ..heuristics.mask_heuristics import _empty
        from ..models.sam import SAM, SAMConfig
        sd = ch.sam_state_dict(_load(path))
        model = _empty(SAM, cfg or SAMConfig(), device=device)
        model.load_state_dict(sd, strict=True)
        assert _finite(model), "non-finite parameters"
        return f"{_numel(sd) / 1e6:.1f}M"

    _row(report, "sam_convert", _convert)


def _p2g_unet(path, cfg, device):
    """(config, UNet, cc_projection) of a pix2gestalt LDM ckpt: the
    conditioning layout from the file, channel overrides from `cfg`."""
    import dataclasses

    from ..convert import heuristics as ch
    from ..heuristics.mask_heuristics import _empty
    from ..models.unet_ldm import UNetModel

    ldm = _load(path)
    ldm_sd = ldm.get("state_dict", ldm)
    det, cc = ch.p2g_cfg_from_ckpt(ldm_sd)
    if cfg is not None:
        det = dataclasses.replace(cfg, cond_mode=det.cond_mode)
    unet = _empty(UNetModel, det.unet, device=device)
    unet.load_state_dict(ch.pix2gestalt_unet_state_dict(ldm_sd), strict=True)
    return det, unet, cc


def check_pix2gestalt(report, path, cfg, device):
    def _convert():
        det, unet, cc = _p2g_unet(path, cfg, device)
        assert _finite(unet), "non-finite parameters"
        cin = unet.state_dict()["input_blocks.0.0.weight"].shape[1]
        assert cin == det.unet.in_channels, \
            f"conv_in channels {cin} != config {det.unet.in_channels}"
        return (f"p2g UNet {_numel(unet.state_dict()) / 1e6:.1f}M, "
                f"cond_mode={det.cond_mode} (conv_in {cin})"
                + (", cc_projection" if cc is not None else ""))

    _row(report, "pix2gestalt_convert", _convert)


def check_p2g_clip_divergence(report, path, cfg, device):
    """The completion end to end with both CLIP-input candidates
    ("occluded" vs "masked_object") on the loaded UNet: the outputs must
    diverge, so that on checkpoint day running both against the published
    demo render excludes the wrong one (reference app.py:113-122)."""

    def _run():
        import dataclasses

        import torch

        from ..heuristics.mask_heuristics import (MaskHeuristics, _empty,
                                                  init_heuristics_)
        from ..models.clip_vit import CLIPVisionConfig
        from ..models.pix2gestalt import Pix2Gestalt
        from ..models.sam import SAM
        from ..models.vae import VAEConfig

        det, unet, cc = _p2g_unet(path, cfg, device)
        det = dataclasses.replace(det, ddim_steps=2,
                                  image_size=min(det.image_size, 32))
        clip_cfg = CLIPVisionConfig(image_size=32, patch_size=8, width=32,
                                    depth=2, num_heads=2,
                                    projection_dim=det.context_dim)
        vae_cfg = VAEConfig(block_out_channels=(16, 32), layers_per_block=1)
        gen = torch.Generator(device=device).manual_seed(5)
        p2g = init_heuristics_(_empty(
            Pix2Gestalt, det, clip_cfg, vae_cfg, device=device,
            cc_in=0 if cc is None else cc["weight"].shape[1],
            cc_bias=cc is not None and "bias" in cc), gen)
        sd = dict(unet.state_dict())
        # an untrained LDM UNet zero-inits its output projections, which
        # makes it blind to the context: nudge exactly the all-zero
        # matrices (crc32 seeds: the same values in every process)
        for k, v in sd.items():
            if v.dim() >= 2 and not bool(v.any()):
                g = torch.Generator().manual_seed(zlib.crc32(k.encode()))
                sd[k] = torch.randn(v.shape, generator=g).to(v) * 0.2
        p2g.unet.load_state_dict(sd, strict=True)
        sam = init_heuristics_(_empty(SAM, tiny_configs()["sam"],
                                      device=device), gen)
        rng = np.random.default_rng(3)
        img = (rng.random((48, 48, 3)) * 255).astype(np.uint8)
        mask = np.zeros((48, 48), np.uint8)
        mask[12:30, 8:24] = 1
        outs = {}
        for choice in ("occluded", "masked_object"):
            p2g.cfg = dataclasses.replace(det, clip_input=choice)
            h = MaskHeuristics(sam, p2g)
            outs[choice] = h.pix2gestalt_completion(img, mask,
                                                    captured=False)
            assert np.isfinite(outs[choice]).all(), \
                f"non-finite completion for clip_input={choice}"
        delta = float(np.abs(outs["occluded"] - outs["masked_object"]).max())
        assert delta > 1e-4, (f"CLIP-input candidates indistinguishable "
                              f"(max delta {delta:.2e})")
        return (f"candidates diverge: max|occluded - masked_object| "
                f"= {delta:.4f} (selection is mechanical)")

    _row(report, "p2g_clip_input_divergence", _run)


def check_rmbg(report, path, cfg, device):
    def _convert():
        from ..convert import heuristics as ch
        from ..heuristics.mask_heuristics import _empty
        from ..models.rmbg import ISNet, RMBGConfig
        sd = ch.fold_rmbg_batchnorm(_load(path))
        model = _empty(ISNet, cfg or RMBGConfig(), device=device)
        model.load_state_dict(sd, strict=True)
        assert _finite(model), "non-finite folded parameters"
        return f"{_numel(sd) / 1e6:.1f}M (BN folded)"

    _row(report, "rmbg_convert", _convert)


def _zoe(path, cfg, device):
    from ..convert.zoedepth_convert import zoedepth_state_dict
    from ..heuristics.mask_heuristics import _empty
    from ..models.zoedepth import InvisibleStitch, ZoeDepthConfig
    model = _empty(InvisibleStitch, cfg or ZoeDepthConfig(), device=device)
    model.load_state_dict(zoedepth_state_dict(_load(path), model),
                          strict=True)
    return model.eval()


def check_invisible_stitch(report, path, cfg, device):
    def _convert():
        model = _zoe(path, cfg, device)
        assert _finite(model), "non-finite parameters"
        return f"{_numel(model.state_dict()) / 1e6:.1f}M"

    _row(report, "invisible_stitch_convert", _convert)


def check_is_prep_divergence(report, path, cfg, device):
    """The InvisibleStitch ZoeDepth end to end with both plausible
    5-channel preps (mean / std 0.5 on the rgb channels only, vs on all
    five): the outputs must diverge, so that the released
    `invisible-stitch.pt` settles the question with one command."""

    def _run():
        import torch

        model = _zoe(path, cfg, device)
        w = model.backbone.patch_embed.proj.weight     # OIHW
        with torch.no_grad():
            if w.shape[1] > 3 and not bool(w[:, 3:].any()):
                # the reference zero-inits the non-rgb input channels;
                # nudge exactly that slice
                g = torch.Generator().manual_seed(11)
                w[:, 3:] = (torch.randn(w[:, 3:].shape, generator=g)
                            * float(w[:, :3].std() + 1e-3)).to(w)
        s = model.cfg.backbone.img_size
        rng = np.random.default_rng(7)

        def t(a):
            return torch.from_numpy(a.astype(np.float32)).to(device)

        x = t(rng.random((1, s, s, 3)))
        inv = t(rng.random((1, s, s, 1)) > 0.6)
        obs = t(rng.random((1, s, s, 1)))
        with torch.no_grad():
            out_rgb_only = model(x, invisible_mask=inv, observation=obs)
            inp5 = torch.cat([(x - 0.5) / 0.5,
                              (obs * (1.0 - inv) - 0.5) / 0.5,
                              (1.0 - inv - 0.5) / 0.5], dim=-1)
            out_all5 = super(type(model), model).forward(inp5)
        a, b = out_rgb_only.cpu().numpy(), out_all5.cpu().numpy()
        assert np.isfinite(a).all() and np.isfinite(b).all(), \
            "non-finite prediction"
        delta = float(np.abs(a - b).max())
        rel = delta / max(float(a.max() - a.min()), 1e-12)
        assert rel > 0.01, (f"prep candidates indistinguishable (max delta "
                            f"{delta:.2e} = {rel:.1%} of output range)")
        return (f"candidates diverge: max|rgb_only - all5| = {delta:.2e}"
                f" ({rel:.0%} of output range; selection is mechanical)")

    _row(report, "invisible_stitch_prep_divergence", _run)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    device = torch.device(args.device)
    tmpdir = None
    if args.rehearse is not None:
        if args.rehearse:
            rdir = args.rehearse
        else:
            import tempfile
            tmpdir = tempfile.TemporaryDirectory(prefix="rehearse_ckpts_")
            rdir = tmpdir.name
        print(f"synthesizing rehearsal checkpoints into {rdir} ...")
        synthesize_rehearsal(rdir, device=device)
        args.all = rdir
        args.tiny = True
        args.quality = True
        args.depthfm_size = 32
        if args.image is None and _image_and_mask(args) is None:
            args.image, args.mask = _rehearsal_inputs(rdir)

    if args.all:
        for attr, names in CANONICAL:
            if getattr(args, attr):
                continue  # an explicit flag wins
            for name in names:
                cand = os.path.join(args.all, name)
                if os.path.exists(cand):
                    setattr(args, attr, cand)
                    break

    tc = tiny_configs() if args.tiny else {}
    report = Report()
    print(f"{'check':<32} {'status':<6} detail")
    print("-" * 74)

    for attr, raw in (("dav2_base", True), ("dav2_amodal", False)):
        if getattr(args, attr):
            check_dav2(report, getattr(args, attr), raw=raw,
                       skip_forward=args.skip_forward, device=device)
        else:
            report.add(f"{attr}_convert", "SKIP", f"--{attr} not given")

    if args.dav2_base and args.dav2_amodal:
        if args.skip_chain:
            report.add("full_chain_1e-3", "SKIP", "--skip_chain")
        else:
            check_full_chain(report, args)
        if args.quality:
            check_quality(report, args)
    else:
        report.add("full_chain_1e-3", "SKIP", "needs both dav2 ckpts")

    if args.depthfm:
        check_depthfm(report, args.depthfm, args.skip_forward, device)
        if args.depthfm_vae and not args.skip_forward:
            check_depthfm_pipeline(report, args)
        else:
            report.add("depthfm_pipeline_forward", "SKIP",
                       "--depthfm_vae not given" if not args.depthfm_vae
                       else "--skip_forward")
    else:
        report.add("depthfm_convert", "SKIP", "--depthfm not given")

    for attr, fn, key in (("sam", check_sam, "sam"),
                          ("pix2gestalt", check_pix2gestalt, "p2g"),
                          ("rmbg", check_rmbg, "rmbg"),
                          ("invisible_stitch", check_invisible_stitch,
                           "zoe")):
        path = getattr(args, attr)
        if path:
            fn(report, path, tc.get(key), device)
        else:
            report.add(f"{attr}_convert", "SKIP", f"--{attr} not given")

    for attr, fn, key, row in (
            ("pix2gestalt", check_p2g_clip_divergence, "p2g",
             "p2g_clip_input_divergence"),
            ("invisible_stitch", check_is_prep_divergence, "zoe",
             "invisible_stitch_prep_divergence")):
        path = getattr(args, attr)
        if path and not args.skip_forward:
            fn(report, path, tc.get(key), device)
        else:
            report.add(row, "SKIP", f"--{attr} not given" if not path
                       else "--skip_forward")

    if tmpdir is not None:
        tmpdir.cleanup()
    if args.output:
        with open(args.output, "w") as f:
            f.write(report.text())
    print("-" * 74)
    print("FAIL" if report.failed else "OK")
    return 1 if report.failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
