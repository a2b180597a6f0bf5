"""Reference-checkpoint migration: the reference repo's torch state dicts
-> the port's models, the JAX package's ``compat.py``.

Checkpoints trained with the reference repo
(phbgomes22/FastFourierConvolution) carry over in two steps. The
converters below turn a reference state dict into the JAX package's
variable layout (nested dicts of numpy arrays, ``{params, batch_stats}``
or ``{params, spectral}``), as the JAX converters do; then
:func:`to_state_dict` feeds that tree through ``bridge.jax_to_state_dict``,
so the port keeps one mapping from the JAX layout to its own.

  * :func:`convert_fgan_generator`: the flagship ``FGenerator`` (Linear
    stem, FFC_BN_ACT upsampling ladder with per-block noise injection,
    FFC to-RGB tail) -> ``FFCGenerator``;
  * :func:`convert_fcond_generator`: the conditional ``FCondGenerator``
    (ConvT stem) and ``FCondGeneratorSTL`` (dense stem) ->
    ``FFCCondGenerator``;
  * :func:`convert_sn_discriminator`: the 7-conv spectral-norm
    ``Discriminator`` -> ``SNConvDiscriminator``;
  * :func:`convert_cond_sn_discriminator`: its conditional twin (a label
    embedding as an extra image plane) -> ``CondSNDiscriminator``;
  * :func:`load_reference_checkpoint`: unwraps the reference's
    ``{model_state_dict, optimizer_state_dict, ...}`` container
    (reference models/ffcmodel.py:66-107).

The layout rules, a numpy copy of the JAX package's:

  * conv OIHW -> HWIO; conv-transpose IOHW -> HWIO, spatially flipped (the
    JAX package's transposed convolution is an input-dilated forward
    convolution);
  * Linear (out, in) -> (in, out), with the stem's NCHW -> NHWC reshape
    permutation folded into the kernel;
  * the FourierUnit's interleaved re/im channel order (torch
    ``stack(..., dim=-1).view``) -> the concatenated [re; im] order
    (kernel rows and columns and BN vectors permuted);
  * BatchNorm weight/bias -> scale/bias params, running statistics ->
    ``batch_stats``;
  * spectral-norm ``weight_orig``/``weight_u`` -> kernel and the
    ``spectral`` u vector.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .bridge import jax_to_state_dict


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def load_reference_checkpoint(path_or_dict) -> Dict:
    """A reference ``.pth`` state dict (``torch.load`` on the CPU, tensors
    only); the FFCModel checkpoint container unwrapped where present
    (reference models/ffcmodel.py:66-107)."""
    sd = path_or_dict
    if isinstance(sd, (str, bytes)):
        sd = torch.load(sd, map_location="cpu", weights_only=True)
    if "model_state_dict" in sd:
        sd = sd["model_state_dict"]
    return sd


def to_state_dict(model: torch.nn.Module, variables: Dict) -> Dict[str, torch.Tensor]:
    """The port's state dict for ``model`` from a converter's variables."""
    return jax_to_state_dict(model, variables["params"], variables.get("batch_stats"),
                             variables.get("spectral"))


def _conv(sd, key) -> np.ndarray:
    """torch Conv2d OIHW -> HWIO."""
    return np.ascontiguousarray(np.transpose(_np(sd[key]), (2, 3, 1, 0)))


def _convt(sd, key) -> np.ndarray:
    """torch ConvTranspose2d IOHW -> HWIO, spatially flipped."""
    w = _np(sd[key])[:, :, ::-1, ::-1]
    return np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1)))


def _bn(sd, prefix: str, params_out: Dict, stats_out: Dict, perm=None) -> None:
    def take(name):
        v = _np(sd[f"{prefix}.{name}"])
        return v[perm] if perm is not None else v

    params_out["scale"] = take("weight")
    params_out["bias"] = take("bias")
    stats_out["mean"] = take("running_mean")
    stats_out["var"] = take("running_var")


def _interleave_perm(c: int) -> np.ndarray:
    """Concatenated index k (= c + p*C) -> torch-interleaved index 2c+p
    (reference fourier_unity.py:40-42 stacks re/im channel-interleaved)."""
    k = np.arange(2 * c)
    return 2 * (k % c) + (k // c)


def _spectral_transform(sd, prefix: str, params: Dict, stats: Dict) -> None:
    """Reference SpectralTransform (conv1+bn1 -> FourierUnit -> conv2,
    SELayer; spectral_transform.py:34-110) -> the convg2g subtrees. LFU
    weights are skipped: its use is commented out in the reference forward
    (:94-105)."""
    params["Conv2d_0"] = {"kernel": _conv(sd, f"{prefix}.conv1.weight")}
    params["Conv2d_1"] = {"kernel": _conv(sd, f"{prefix}.conv2.weight")}
    bn_p, bn_s = {}, {}
    _bn(sd, f"{prefix}.bn1", bn_p, bn_s)
    params["BatchNorm_0"] = {"BatchNorm_0": bn_p}
    stats["BatchNorm_0"] = {"BatchNorm_0": bn_s}

    w = _np(sd[f"{prefix}.fu.conv_layer.weight"])[:, :, 0, 0]  # (2C, 2C)
    perm = _interleave_perm(w.shape[0] // 2)
    fu_p, fu_s = {}, {}
    _bn(sd, f"{prefix}.fu.bn", fu_p, fu_s, perm=perm)
    params["FourierUnit_0"] = {"mix_kernel": np.ascontiguousarray(w[np.ix_(perm, perm)].T),
                               "bn_scale": fu_p["scale"], "bn_bias": fu_p["bias"]}
    stats["FourierUnit_0"] = fu_s
    params["SELayer_0"] = {
        "Dense_0": {"kernel": np.ascontiguousarray(_np(sd[f"{prefix}.se_block.fc.0.weight"]).T)},
        "Dense_1": {"kernel": np.ascontiguousarray(_np(sd[f"{prefix}.se_block.fc.2.weight"]).T)},
    }


def _ffc_bn_act(sd, prefix: str, params: Dict, stats: Dict, transpose: bool,
                has_bn: bool) -> None:
    conv = _convt if transpose else _conv
    ffc_p: Dict = {}
    ffc_s: Dict = {}
    for branch in ("convl2l", "convl2g", "convg2l"):
        key = f"{prefix}.ffc.{branch}.weight"
        if key in sd:
            ffc_p[branch] = {"kernel": conv(sd, key)}
    if f"{prefix}.ffc.convg2g.conv1.weight" in sd:
        g2g_p: Dict = {}
        g2g_s: Dict = {}
        _spectral_transform(sd, f"{prefix}.ffc.convg2g", g2g_p, g2g_s)
        ffc_p["convg2g"] = g2g_p
        ffc_s["convg2g"] = g2g_s
    params["ffc"] = ffc_p
    if ffc_s:
        stats["ffc"] = ffc_s
    if not has_bn:
        return
    for side in ("bn_l", "bn_g"):
        if f"{prefix}.{side}.weight" in sd:
            p, s = {}, {}
            _bn(sd, f"{prefix}.{side}", p, s)
            params[side] = {"BatchNorm_0": p}
            stats[side] = {"BatchNorm_0": s}
        elif f"{prefix}.{side}.embed.weight" in sd:
            # class-conditional BN (reference layers/cond/cond_bn.py:
            # Embedding(num_classes, 2C) = [gamma; beta] chunks and an
            # affine-free BatchNorm2d's running statistics)
            emb = _np(sd[f"{prefix}.{side}.embed.weight"])
            c = emb.shape[1] // 2
            params[side] = {"gamma": np.ascontiguousarray(emb[:, :c]),
                            "beta": np.ascontiguousarray(emb[:, c:])}
            stats[side] = {"BatchNorm_0": {
                "mean": _np(sd[f"{prefix}.{side}.bn.running_mean"]),
                "var": _np(sd[f"{prefix}.{side}.bn.running_var"]),
            }}


def _dense_stem_nchw(sd, prefix: str, mg: int) -> Dict:
    """Linear stem (out, in) -> (in, out) with the reshape permutation: torch
    reshapes the output vector to NCHW (C, mg, mg), the JAX layout to NHWC
    (mg, mg, C), so the (c, h, w) -> (h, w, c) reorder is folded into the
    kernel."""
    w = _np(sd[f"{prefix}.weight"])  # (out, in)
    b = _np(sd[f"{prefix}.bias"])
    torch_idx = _nchw_index(w.shape[0], mg)
    return {"kernel": np.ascontiguousarray(w[torch_idx, :].T), "bias": b[torch_idx]}


def _nchw_index(size: int, mg: int) -> np.ndarray:
    """For each index of a flattened (mg, mg, C) NHWC vector of ``size``
    elements, the index of the same element flattened from (C, mg, mg)
    NCHW."""
    ch = size // (mg * mg)
    j = np.arange(size)
    h, wpos, c = j // (mg * ch), (j // ch) % mg, j % ch
    return c * mg * mg + h * mg + wpos


def _convert_ffc_ladder(sd, params: Dict, stats: Dict,
                        num_blocks: Optional[int] = None) -> None:
    """conv2..conv{N+1} FFC up-blocks, the conv{N+2} to-RGB tail and their
    per-block noise injections: the body shared by every script
    FGenerator variant, conditional or not (reference
    fgan_complete.py:92-134, fgan_cond_complete.py:42-110)."""
    if num_blocks is None:
        idx = sorted(int(k.split(".")[0][4:]) for k in sd
                     if k.startswith("conv") and k.endswith(".ffc.convl2l.weight"))
        if not idx or idx[0] != 2:
            raise ValueError(f"unrecognised FGenerator keys: FFC blocks {idx}")
        num_blocks = len(idx) - 1  # the last conv is the to-RGB tail

    for i in range(num_blocks):
        p: Dict = {}
        s: Dict = {}
        _ffc_bn_act(sd, f"conv{i + 2}", p, s, transpose=True, has_bn=True)
        params[f"block{i}"] = p
        if s:
            stats[f"block{i}"] = s
        for side in ("lcl", "glb"):
            key = f"{side}_noise{i + 2}.weight"
            if key in sd:
                params[f"{side}_noise{i}"] = {"weight": _np(sd[key]).reshape(1, 1, 1, -1)}

    p, s = {}, {}
    _ffc_bn_act(sd, f"conv{2 + num_blocks}", p, s, transpose=False, has_bn=False)
    params["to_rgb"] = p
    if s:
        stats["to_rgb"] = s


def convert_fgan_generator(path_or_dict, mg: int = 4, num_blocks: Optional[int] = None) -> Dict:
    """Reference ``FGenerator`` state dict -> ``FFCGenerator`` variables
    ({params, batch_stats}). The 32/64/128px script variants share one
    naming scheme (fgan_complete.py:92-114, fgan64_complete.py:101-123,
    fgan128_complete.py:458-484): blocks conv2..conv{N} and a ratio-0
    tail conv{N+1}; ``num_blocks`` is read from the keys when not given.
    conv{i+2} -> block{i}; the tail -> to_rgb; lcl/glb_noise{i+2} ->
    lcl/glb_noise{i}."""
    sd = load_reference_checkpoint(path_or_dict)
    params: Dict = {"noise_to_feature": _dense_stem_nchw(sd, "noise_to_feature.0", mg)}
    stats: Dict = {}
    _convert_ffc_ladder(sd, params, stats, num_blocks)
    return {"params": params, "batch_stats": stats}


def convert_fcond_generator(path_or_dict, mg: int = 4,
                            num_blocks: Optional[int] = None) -> Dict:
    """Reference conditional ``FCondGenerator`` state dict ->
    ``FFCCondGenerator`` variables ({params, batch_stats}), either stem of
    the reference's fgan_cond_complete.py:

      * ConvT stem (:63-93): ``label_embed`` -> ``label_conv``
        ConvT(4,1,0)+BN+GELU; z -> its ``input_conv`` twin; channel concat
        (also the fgan128_cond_complete.py:75-105 layout);
      * dense stem (``FCondGeneratorSTL`` :117-186): concat(z, embed) ->
        ``noise_to_feature`` Linear.

    The FFC ladder (class-conditional BN) maps as the unconditional one."""
    sd = load_reference_checkpoint(path_or_dict)
    params: Dict = {"label_embed": _np(sd["label_embed.weight"])}
    stats: Dict = {}
    if "input_conv.0.weight" in sd:
        for name in ("label_conv", "input_conv"):
            params[name] = {"kernel": _convt(sd, f"{name}.0.weight"),
                            "bias": _np(sd[f"{name}.0.bias"])}
        for ours, theirs in (("label_bn", "label_conv.1"), ("input_bn", "input_conv.1")):
            p, s = {}, {}
            _bn(sd, theirs, p, s)
            params[ours] = {"BatchNorm_0": p}
            stats[ours] = {"BatchNorm_0": s}
    elif "noise_to_feature.weight" in sd:
        params["noise_to_feature"] = _dense_stem_nchw(sd, "noise_to_feature", mg)
    else:
        raise ValueError("unrecognised conditional-generator stem: expected "
                         "input_conv.0.weight (ConvT stem) or noise_to_feature.weight "
                         "(dense STL stem)")
    _convert_ffc_ladder(sd, params, stats, num_blocks)
    return {"params": params, "batch_stats": stats}


def convert_sn_discriminator(path_or_dict, mg: int = 4) -> Dict:
    """Reference 7-conv SN ``Discriminator`` (fgan_complete.py:142-171) ->
    ``SNConvDiscriminator`` variables ({params, spectral}). torch's
    spectral norm keeps ``weight_orig`` (the unnormalised kernel) and the
    power-iteration vector ``weight_u`` over the (out, in*k*k)
    matricisation, the JAX package's u convention, so both carry over."""
    sd = load_reference_checkpoint(path_or_dict)
    params: Dict = {}
    spectral: Dict = {}
    i = 0
    while f"conv{i + 1}.weight_orig" in sd or f"conv{i + 1}.weight" in sd:
        name, tkey = f"conv{i}", f"conv{i + 1}"
        if f"{tkey}.weight_orig" in sd:
            kernel = _np(sd[f"{tkey}.weight_orig"])
            spectral[name] = {"u": _np(sd[f"{tkey}.weight_u"])}
        else:
            kernel = _np(sd[f"{tkey}.weight"])
        entry = {"kernel": np.ascontiguousarray(np.transpose(kernel, (2, 3, 1, 0)))}
        if f"{tkey}.bias" in sd:
            entry["bias"] = _np(sd[f"{tkey}.bias"])
        params[name] = entry
        i += 1
    fc_key = "fc.weight_orig" if "fc.weight_orig" in sd else "fc.weight"
    if fc_key in sd:
        w = _np(sd[fc_key])  # (1, mg*mg*C), flattened NCHW (c-major)
        torch_idx = _nchw_index(w.shape[1], mg)
        params["fc"] = {"kernel": np.ascontiguousarray(w[:, torch_idx].T),
                        "bias": _np(sd["fc.bias"])}
        if "fc.weight_u" in sd:
            spectral["fc"] = {"u": _np(sd["fc.weight_u"])}
    return {"params": params, "spectral": spectral}


def convert_cond_sn_discriminator(path_or_dict, mg: int = 4) -> Dict:
    """Reference conditional SN ``Discriminator``
    (fgan_cond_complete.py:189-227: 7 SN convs, an SN fc and a label
    embedding reshaped to one extra image plane) -> ``CondSNDiscriminator``
    variables ({params, spectral})."""
    sd = load_reference_checkpoint(path_or_dict)
    out = convert_sn_discriminator(sd, mg=mg)
    out["params"]["label_embed"] = _np(sd["label_embed.weight"])
    return out
