"""Weights carried across from the JAX package.

``from_jax_variables`` turns the JAX model's ``{"params", "batch_stats"}``
(numpy arrays) into the port's state_dict. The port's parameter names are
the reference's torch state_dict keys, so the JAX package's own
``models/convert_ref.py::convert_reference_state_dict`` is the inverse: it
maps a port state_dict back onto the flax tree and raises on any key it
does not use. Covered: ``tri_mbt_vsltcls`` (and its bimodal aliases),
``bi_vslttxt_mbt_v1``, ``bi_vsltimg_mbt_v1``, ``tri_mbt_v1``,
``unimodal_transformer`` under every UMSE branch, the multitoken family
(``tri_mbt_vmulti``, ``tri_mbt_vmulti2``, ``tri_mbt_vmultivslt``) and the
cross transformer. The JAX package's bridge does not reach the multitoken
trees; their port names follow the reference's other MBT fusions
(``cls_token_per_modality``, ``bottlenecks``, ``layer_norms_in``,
``layer_stacks``), with ``cls_token`` for the VSLTMAIN fusion's single
cls parameter (its flax name), ``layer_norms_after_concat`` and
``fc_lists.{i}``. The legacy cross transformer has no reference state_dict
names in the JAX package's bridge; its port modules are named after the
flax tree instead (``models/legacy.py``).

Layout rules (the inverse of convert_ref's): flax kernel [in, out] ->
torch Linear weight [out, in]; FFN kernels -> Conv1d weights [out, in, 1];
LayerNorm scale/bias -> weight/bias; BatchNorm running stats from
batch_stats. The Swin trunk goes under torchvision's ``swin_t`` names
(the inverse of the JAX package's ``models/convert.py::convert_swin_t``):
conv kernels [kh, kw, in, out] -> [out, in, kh, kw], and the patch
merges' 4C axis back from the JAX group order to torchvision's.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..config import Config


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _lin(sd, key: str, p: Mapping) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{key}.bias"] = _t(p["bias"])


def _ln(sd, key: str, p: Mapping) -> None:
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])


def _stem(sd, key: str, p: Mapping) -> None:
    """MLPStem tree -> Sequential(Linear, LayerNorm, ReLU)."""
    _lin(sd, f"{key}.0", p["Dense_0"])
    _ln(sd, f"{key}.1", p["LayerNorm_0"])


def _encoder_layer(sd, base: str, p: Mapping,
                   prenorms=("attention_prenorm", "feed_forward_prenorm")
                   ) -> None:
    for name in prenorms:
        sd[f"{base}.{name}.gamma"] = _t(p[name]["gamma"])
        sd[f"{base}.{name}.beta"] = _t(p[name]["beta"])
    for name in ("query_proj", "key_proj", "value_proj"):
        _lin(sd, f"{base}.self_attention.{name}.linear",
             p["self_attention"][name])
    for w in ("w_1", "w_2"):
        kern = np.asarray(p["feed_forward"][w]["kernel"])   # [in, out]
        sd[f"{base}.feed_forward.{w}.weight"] = _t(kern.T[:, :, None])
        sd[f"{base}.feed_forward.{w}.bias"] = _t(p["feed_forward"][w]["bias"])


def _txt_embedding(sd, key: str, p: Mapping) -> None:
    """The note embedding: a Dense over BioBERT vectors, or under
    ``--berttype bert`` an Embed table -> ``nn.Embedding`` weight."""
    if "embedding" in p:
        sd[f"{key}.weight"] = _t(p["embedding"])
    else:
        _lin(sd, key, p)


def _cross_layer(sd, base: str, p: Mapping) -> None:
    """CrossmodalTransformerEncoderLayer: the encoder layer's tree with the
    q and kv pre-norms in place of the attention pre-norm."""
    _encoder_layer(sd, base, p, ("attention_prenorm_q",
                                 "attention_prenorm_kv",
                                 "feed_forward_prenorm"))


# the JAX PatchMerging's neighbour groups against torchvision's
# (medical_tri_modal_pilot_tpu/models/convert.py:60); a swap, so its own
# inverse
_MERGE_PERM = (0, 2, 1, 3)


def _merge_permute(a: np.ndarray, C: int) -> np.ndarray:
    groups = np.asarray(a).reshape(4, C, *np.shape(a)[1:])
    return groups[list(_MERGE_PERM)].reshape(np.shape(a))


def swin_state_dict(p: Mapping, pre: str = "") -> Dict[str, torch.Tensor]:
    """Flax ``SwinTransformer`` params -> the port's trunk state_dict, keys
    prefixed with ``pre``. Stages and depths are read from the tree."""
    sd: Dict[str, torch.Tensor] = {}
    kern = np.asarray(p["patch_embed"]["kernel"])             # [kh, kw, I, O]
    sd[f"{pre}features.0.0.weight"] = _t(kern.transpose(3, 2, 0, 1))
    sd[f"{pre}features.0.0.bias"] = _t(p["patch_embed"]["bias"])
    _ln(sd, f"{pre}features.0.2", p["patch_norm"])
    dim = kern.shape[-1]
    si = 0
    while f"stage{si}_block0" in p:
        f = 2 * si + 1
        bi = 0
        while f"stage{si}_block{bi}" in p:
            blk, base = p[f"stage{si}_block{bi}"], f"{pre}features.{f}.{bi}"
            _ln(sd, f"{base}.norm1", blk["norm1"])
            _ln(sd, f"{base}.norm2", blk["norm2"])
            _lin(sd, f"{base}.attn.qkv", blk["attn"]["qkv"])
            _lin(sd, f"{base}.attn.proj", blk["attn"]["proj"])
            sd[f"{base}.attn.relative_position_bias_table"] = _t(
                blk["attn"]["relative_position_bias_table"])
            _lin(sd, f"{base}.mlp.0", blk["mlp_fc1"])
            _lin(sd, f"{base}.mlp.3", blk["mlp_fc2"])
            bi += 1
        if f"merge{si}" in p:
            m, base = p[f"merge{si}"], f"{pre}features.{f + 1}"
            sd[f"{base}.norm.weight"] = _t(
                _merge_permute(m["norm"]["scale"], dim))
            sd[f"{base}.norm.bias"] = _t(_merge_permute(m["norm"]["bias"],
                                                        dim))
            sd[f"{base}.reduction.weight"] = _t(
                _merge_permute(m["reduction"]["kernel"], dim).T)
            dim *= 2
        si += 1
    _ln(sd, f"{pre}norm", p["norm"])
    return sd


def _fusion(sd, pre: str, p: Mapping, n_mod: int) -> None:
    """MBTFusion tree -> ``{pre}.bottlenecks``, ``.cls_token_per_modality``,
    ``.layer_norms_in``, ``.layer_stacks.{layer}.{modality}``."""
    sd[f"{pre}.bottlenecks"] = _t(p["bottlenecks"])
    for m in range(n_mod):
        sd[f"{pre}.cls_token_per_modality.{m}"] = _t(p[f"cls_token_{m}"])
        _ln(sd, f"{pre}.layer_norms_in.{m}", p[f"layer_norm_in_{m}"])
    for key, layer in p.items():
        if key.startswith("layers_"):
            _, li, m = key.split("_")
            _encoder_layer(sd, f"{pre}.layer_stacks.{li}.{m}", layer)


def _multitoken_fusion(sd, pre: str, p: Mapping) -> None:
    """MultitokenMBTFusion (``cls_tokens_{m}``, ``bottlenecks_{g}``) or
    MultitokenMBTVSLTMAINFusion (``cls_token``, ``bottlenecks``) ->
    ``{pre}.cls_token_per_modality.{m}`` / ``.cls_token``,
    ``.bottlenecks.{g}`` / ``.bottlenecks``, ``.layer_norms_in.{m}``,
    ``.layer_stacks.{layer}.{m}``."""
    if "cls_token" in p:
        sd[f"{pre}.cls_token"] = _t(p["cls_token"])
        sd[f"{pre}.bottlenecks"] = _t(p["bottlenecks"])
    else:
        for m in range(3):
            sd[f"{pre}.cls_token_per_modality.{m}"] = _t(p[f"cls_tokens_{m}"])
        for g in range(4):
            sd[f"{pre}.bottlenecks.{g}"] = _t(p[f"bottlenecks_{g}"])
    for m in range(3):
        _ln(sd, f"{pre}.layer_norms_in.{m}", p[f"layer_norm_in_{m}"])
    for key, layer in p.items():
        if key.startswith("layers_"):
            _, li, m = key.split("_")
            _encoder_layer(sd, f"{pre}.layer_stacks.{li}.{m}", layer)


def _ln_head(sd, key: str, head: Mapping) -> None:
    """ClsHeadLN (fc1, ln, fc2) -> Linear, LayerNorm, Linear."""
    _lin(sd, f"{key}.0", head["fc1"])
    _ln(sd, f"{key}.1", head["ln"])
    _lin(sd, f"{key}.3", head["fc2"])


_MULTITOKEN_MODELS = ("tri_mbt_vmulti", "tri_mbt_vmulti2",
                      "tri_mbt_vmultivslt")


def _multitoken(params: Mapping) -> Dict[str, torch.Tensor]:
    """The multitoken models: the stems, the trunk and its projection
    (``img_enc``), the fusion, ``after_concat_ln`` and the four LayerNorm
    heads ``fc_lists_{i}`` (JAX models.py:564-667)."""
    sd: Dict[str, torch.Tensor] = {}
    _umse(sd, params["umse"])
    img = params["img_enc"]
    sd.update(swin_state_dict(img["img_encoder"], "img_encoder."))
    _lin(sd, "linear", img["linear"])
    _multitoken_fusion(sd, "fusion_transformer", params["fusion_transformer"])
    _ln(sd, "layer_norms_after_concat", params["after_concat_ln"])
    for i in range(4):
        _ln_head(sd, f"fc_lists.{i}", params[f"fc_lists_{i}"])
    return sd


def _cls_head(sd, params: Mapping, stats: Mapping) -> None:
    """ClsHead ``fc_list`` (fc1, bn, fc2) -> Linear, BatchNorm1d, Linear;
    ClsHeadLN (fc1, ln, fc2) -> Linear, LayerNorm, Linear."""
    head = params["fc_list"]
    if "ln" in head:
        _ln_head(sd, "fc_list", head)
        return
    _lin(sd, "fc_list.0", head["fc1"])
    sd["fc_list.1.weight"] = _t(head["bn"]["scale"])
    sd["fc_list.1.bias"] = _t(head["bn"]["bias"])
    bn = stats["fc_list"]["bn"]
    sd["fc_list.1.running_mean"] = _t(bn["mean"])
    sd["fc_list.1.running_var"] = _t(bn["var"])
    sd["fc_list.1.num_batches_tracked"] = torch.tensor(0)
    _lin(sd, "fc_list.3", head["fc2"])


_CROSS_TRANSFORMERS = ("cross_transformer_txt_vslt",
                       "bi_cross_transformer_txt_vslt")


def _cross_transformer(params: Mapping, stats: Mapping
                       ) -> Dict[str, torch.Tensor]:
    """The legacy CROSS_TRANSFORMER tree: the port's names are the flax
    module names."""
    sd: Dict[str, torch.Tensor] = {}
    _lin(sd, "vslt_tokens.init_fc", params["vslt_tokens"]["init_fc"])
    _txt_embedding(sd, "txt_tokens.txt_embedding",
                   params["txt_tokens"]["txt_embedding"])
    for key, layer in params.items():
        if key.startswith("self_"):
            _encoder_layer(sd, key, layer)
        elif key.startswith("cross_"):
            _cross_layer(sd, key, layer)
    _lin(sd, "merge", params["merge"])
    _ln(sd, "final_ln", params["final_ln"])
    _cls_head(sd, params, stats)
    return sd


_MBT_MODELS = ("tri_mbt_vsltcls", "biimg_mbt_vsltcls", "bitxt_mbt_vsltcls",
               "bi_vslttxt_mbt_v1", "bi_vsltimg_mbt_v1", "tri_mbt_v1")


def _umse(sd, p: Mapping) -> None:
    """The UMSE stems the JAX model holds (its tree has the ones its
    inputs use): the MLPStems, the feature-id table and the note
    embedding."""
    for name in ("vslt_enc", "ie_vslt", "ie_time", "ie_demo"):
        if name in p:
            _stem(sd, name, p[name])
    if "ie_feat" in p:
        sd["ie_feat.weight"] = _t(p["ie_feat"]["embedding"])
    if "txt_embedding" in p:
        _txt_embedding(sd, "txt_embedding", p["txt_embedding"])


def _encoder(sd, pre: str, p: Mapping) -> None:
    """TransformerEncoder tree -> ``{pre}.cls_tokens``,
    ``.layer_norm_in``, ``.layer_stack.{i}``."""
    sd[f"{pre}.cls_tokens"] = _t(p["cls_tokens"])
    _ln(sd, f"{pre}.layer_norm_in", p["layer_norm_in"])
    for key, layer in p.items():
        if key.startswith("layers_"):
            _encoder_layer(sd, f"{pre}.layer_stack.{key.split('_')[1]}",
                           layer)


def _unimodal(params: Mapping, stats: Mapping) -> Dict[str, torch.Tensor]:
    """UNIMODAL_TRANSFORMER: the stems, ``transformer_encoder`` (its
    ``layers_i`` at ``layer_stack.i``), ``final_ln`` at
    ``layer_norm_final``, the head (convert_ref.py:195-206)."""
    sd: Dict[str, torch.Tensor] = {}
    _umse(sd, params["umse"])
    _encoder(sd, "transformer_encoder", params["transformer_encoder"])
    _ln(sd, "layer_norm_final", params["final_ln"])
    _cls_head(sd, params, stats)
    return sd


def from_jax_variables(cfg: Config, variables: Mapping
                       ) -> Dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` of ``cfg.model`` -> port
    state_dict (fp32 tensors)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    if cfg.model in _CROSS_TRANSFORMERS:
        return _cross_transformer(params, stats)
    if cfg.model == "unimodal_transformer":
        return _unimodal(params, stats)
    if cfg.model in _MULTITOKEN_MODELS:
        return _multitoken(params)
    if cfg.model not in _MBT_MODELS:
        raise NotImplementedError(
            f"no weight bridge for model '{cfg.model}' yet")
    sd: Dict[str, torch.Tensor] = {}
    _umse(sd, params["backbone"]["umse"])
    if "img" in cfg.input_types.split("_"):
        img = params["backbone"]["img_enc"]
        sd.update(swin_state_dict(img["img_encoder"], "img_encoder."))
        _lin(sd, "linear", img["linear"])

    _fusion(sd, "fusion_transformer",
            params["backbone"]["fusion_transformer"],
            len(cfg.input_types.split("_")))
    _ln(sd, "layer_norms_after_concat", params["after_concat_ln"])
    _cls_head(sd, params, stats)
    if "rmse_layer" in params:
        _lin(sd, "rmse_layer", params["rmse_layer"])
    return sd


def params_from_jax(cfg: Config, tree: Mapping) -> Dict[str, torch.Tensor]:
    """A tree shaped like the JAX model's params (the params, or an
    optimizer's moments of them) -> the port's parameter names, with the
    same layout rules (buffers left out)."""
    stub = {"fc_list": {"bn": {"mean": np.zeros(1), "var": np.zeros(1)}}}
    sd = from_jax_variables(cfg, {"params": tree, "batch_stats": stub})
    return {k: v for k, v in sd.items()
            if not (k.startswith("fc_list.1.running")
                    or k.endswith("num_batches_tracked"))}


def _fill_masked(tree, params):
    """optax.masked leaves (MaskedNode, an empty NamedTuple) -> zeros of
    the parameter's shape."""
    if isinstance(tree, Mapping):
        return {k: _fill_masked(tree[k], params[k]) for k in tree}
    if isinstance(tree, tuple) and getattr(tree, "_fields", None) == ():
        return np.zeros(np.shape(params), np.float32)
    return tree


def _find_state(state, fields):
    if all(f in getattr(state, "_fields", ()) for f in fields):
        return state
    if isinstance(state, (tuple, list)):
        for s in state:
            found = _find_state(s, fields)
            if found is not None:
                return found
    return None


def optimizer_state_from_jax(cfg: Config, opt_state, params: Mapping
                             ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The moments of an optax adam/adamw (``mu``, ``nu``) or sgd
    (``trace``) state, masked leaves as zeros, under torch.optim's state
    names: {"exp_avg": {name: tensor}, "exp_avg_sq": ...} or
    {"momentum_buffer": ...}."""
    adam = _find_state(opt_state, ("count", "mu", "nu"))
    if adam is not None:
        return {"exp_avg": params_from_jax(cfg, _fill_masked(adam.mu, params)),
                "exp_avg_sq": params_from_jax(
                    cfg, _fill_masked(adam.nu, params))}
    trace = _find_state(opt_state, ("trace",))
    if trace is not None:
        return {"momentum_buffer": params_from_jax(
            cfg, _fill_masked(trace.trace, params))}
    raise ValueError("no adam or sgd state in the optimizer state")
