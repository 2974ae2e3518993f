"""Weights carried across from the JAX package.

``from_jax_variables`` turns the JAX model's ``{"params", "batch_stats"}``
(numpy arrays) into the port's state_dict. The port's parameter names are
the reference's torch state_dict keys, so the JAX package's own
``models/convert_ref.py::convert_reference_state_dict`` is the inverse: it
maps a port state_dict back onto the flax tree and raises on any key it
does not use. Covered: ``tri_mbt_vsltcls`` (and its bimodal aliases),
``bi_vslttxt_mbt_v1``, ``bi_vsltimg_mbt_v1``, ``tri_mbt_v1``,
``unimodal_transformer`` under every UMSE branch, the multitoken family
(``tri_mbt_vmulti``, ``tri_mbt_vmulti2``, ``tri_mbt_vmultivslt``), the
MBT ablations (``tri_mbt_vsltcls_noshareumse``, ``tri_mbt_vflexible*``,
``tri_mbt_vnosh*avgtr``), the concat-fusion ``*_mt_v1`` and the cross
transformer; a leaf of the JAX tree left unused raises. The reference's
bridge does not reach the ablations' and ``*_mt_v1``'s own parts either:
they are named after the flax tree (``umse_img``, ``umse_txt``,
``flexibleavg``, ``fc_list_{m}``, ``MTFusion``'s names), with
``layer_norms_after_concat`` and ``fc_list`` as in the other models. The JAX package's bridge does not reach the multitoken
trees; their port names follow the reference's other MBT fusions
(``cls_token_per_modality``, ``bottlenecks``, ``layer_norms_in``,
``layer_stacks``), with ``cls_token`` for the VSLTMAIN fusion's single
cls parameter (its flax name), ``layer_norms_after_concat`` and
``fc_lists.{i}``. The legacy cross transformer has no reference state_dict
names in the JAX package's bridge; its port modules are named after the
flax tree instead (``models/legacy.py``), as are the baselines
(``gru_d``, ``lstm``, ``fusiontrainer``: ``models/baselines.py``; the
recurrent cells' denses one ``nn.Linear`` each under the flax names
``ir`` .. ``hn`` and ``ii`` .. ``ho``, which the port concatenates at run
time; the Swin-T ``cxr_model`` under torchvision's names, as every trunk),
``feature_temporal_v1`` (``models/extras.py``), and the patch stem of
``tri_mbt_v3`` (``patch_embedding.proj``, ``.pos_embed``).

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


class _Tracked(Mapping):
    """A read-only view of a JAX tree that records the leaves read
    through it (``used``: their key paths)."""

    def __init__(self, tree: Mapping, path=(), used=None):
        self._tree, self._path = tree, path
        self.used = set() if used is None else used

    def __getitem__(self, key):
        value = self._tree[key]
        if isinstance(value, Mapping):
            return _Tracked(value, self._path + (key,), self.used)
        self.used.add(self._path + (key,))
        return value

    def __iter__(self):
        return iter(self._tree)

    def __len__(self) -> int:
        return len(self._tree)


def _leaf_paths(tree: Mapping, path=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaf_paths(value, path + (key,))
        else:
            yield path + (key,)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _lin(sd, key: str, p: Mapping) -> None:
    """A flax Dense (kernel [in, out], bias if it has one) -> Linear."""
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
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
    _img(sd, params["img_enc"])
    _multitoken_fusion(sd, "fusion_transformer", params["fusion_transformer"])
    _ln(sd, "layer_norms_after_concat", params["after_concat_ln"])
    for i in range(4):
        _ln_head(sd, f"fc_lists.{i}", params[f"fc_lists_{i}"])
    return sd


def _cls_head(sd, params: Mapping, stats: Mapping,
              key: str = "fc_list") -> None:
    """ClsHead ``key`` (fc1, bn, fc2) -> Linear, BatchNorm1d, Linear;
    ClsHeadLN (fc1, ln, fc2) -> Linear, LayerNorm, Linear."""
    head = params[key]
    if "ln" in head:
        _ln_head(sd, key, head)
        return
    _lin(sd, f"{key}.0", head["fc1"])
    sd[f"{key}.1.weight"] = _t(head["bn"]["scale"])
    sd[f"{key}.1.bias"] = _t(head["bn"]["bias"])
    bn = stats[key]["bn"]
    sd[f"{key}.1.running_mean"] = _t(bn["mean"])
    sd[f"{key}.1.running_var"] = _t(bn["var"])
    sd[f"{key}.1.num_batches_tracked"] = torch.tensor(0)
    _lin(sd, f"{key}.3", head["fc2"])


def _conv(sd, key: str, p: Mapping) -> None:
    """A flax Conv (kernel [kh, kw, in, out]) -> Conv2d [out, in, kh, kw]."""
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{key}.bias"] = _t(p["bias"])


def _img(sd, p: Mapping) -> None:
    """The image encoder's tree (``img_enc``): the trunk and its
    projection ``linear``, or the patch stem ``patch_embedding``."""
    if "patch_embedding" in p:
        _conv(sd, "patch_embedding.proj", p["patch_embedding"]["proj"])
        sd["patch_embedding.pos_embed"] = _t(
            p["patch_embedding"]["pos_embed"])
        return
    sd.update(swin_state_dict(p["img_encoder"], "img_encoder."))
    _lin(sd, "linear", p["linear"])


def _mt_fusion(sd, pre: str, p: Mapping) -> None:
    """MTFusion tree -> the same names under ``pre``: the encoder layers
    (``specific_{m}_{layer}``, ``fusion_{layer}``), the StdLNs
    ``layer_norm_in_{m}`` and the two cls tokens."""
    for key, sub in p.items():
        if key.startswith(("specific_", "fusion_")):
            _encoder_layer(sd, f"{pre}.{key}", sub)
        elif key.startswith("layer_norm_in_"):
            sd[f"{pre}.{key}.gamma"] = _t(sub["gamma"])
            sd[f"{pre}.{key}.beta"] = _t(sub["beta"])
        else:
            sd[f"{pre}.{key}"] = _t(sub)


_MT_MODELS = ("tri_mt_v1", "biimg_mt_v1", "bitxt_mt_v1", "mt_v1")


def _mt(params: Mapping, stats: Mapping) -> Dict[str, torch.Tensor]:
    """MT_FUSION_MODEL (JAX models.py:480-527): the stems, the trunk, the
    ``MTFusion`` tree under its own names, ``after_concat_ln`` at
    ``layer_norms_after_concat`` and the head."""
    sd: Dict[str, torch.Tensor] = {}
    _umse(sd, params["umse"])
    if "img_enc" in params:
        _img(sd, params["img_enc"])
    _mt_fusion(sd, "fusion_transformer", params["fusion_transformer"])
    _ln(sd, "layer_norms_after_concat", params["after_concat_ln"])
    _cls_head(sd, params, stats)
    return sd


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
               "bi_vslttxt_mbt_v1", "bi_vsltimg_mbt_v1", "tri_mbt_v1",
               "tri_mbt_v2", "tri_mbt_v3",
               "tri_mbt_vsltcls_noshareumse", "tri_mbt_vflexible",
               "tri_mbt_vflexible2", "tri_mbt_vflexible3",
               "biimg_mbt_vflexible1", "bitxt_mbt_vflexible1",
               "tri_mbt_vnoshavgtr", "tri_mbt_vnoshnoavgtr")


def _umse(sd, p: Mapping, pre: str = "") -> None:
    """The UMSE stems the JAX model holds (its tree has the ones its
    inputs use): the MLPStems, the feature-id table and the note
    embedding, keys prefixed with ``pre``."""
    for name in ("vslt_enc", "ie_vslt", "ie_time", "ie_demo"):
        if name in p:
            _stem(sd, pre + name, p[name])
    if "ie_feat" in p:
        sd[f"{pre}ie_feat.weight"] = _t(p["ie_feat"]["embedding"])
    if "txt_embedding" in p:
        _txt_embedding(sd, f"{pre}txt_embedding", p["txt_embedding"])


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


def _cells(sd, pre: str, p: Mapping, names: str) -> None:
    """A flax recurrent cell's denses (``names``) -> one Linear each."""
    for name in names.split():
        _lin(sd, f"{pre}.{name}", p[name])


def _lstm_encoder(sd, pre: str, p: Mapping) -> None:
    """LSTMEncoder: ``layer{l}`` -> ``{pre}.layer{l}.cell.{ii .. ho}``."""
    for key, layer in p.items():
        _cells(sd, f"{pre}.{key}.cell", layer["cell"],
               "ii if ig io hi hf hg ho")


def _bn(sd, key: str, p: Mapping, stats: Mapping) -> None:
    """A flax BatchNorm -> BatchNorm1d (its running statistics from
    ``stats``)."""
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])
    sd[f"{key}.running_mean"] = _t(stats["mean"])
    sd[f"{key}.running_var"] = _t(stats["var"])
    sd[f"{key}.num_batches_tracked"] = torch.tensor(0)


def _gru_d(params: Mapping, stats: Mapping) -> Dict[str, torch.Tensor]:
    """GRU_D (JAX baselines.py:46-100): the input decay, the scanned cell
    ``gru`` (``hidden_decay``, the GRU denses), fc1, bn, fc2."""
    sd: Dict[str, torch.Tensor] = {}
    for name in ("input_decay_w", "input_decay_b"):
        sd[name] = _t(params[name])
    _lin(sd, "gru.hidden_decay", params["gru"]["hidden_decay"])
    _cells(sd, "gru.cell", params["gru"]["cell"], "ir iz in hr hz hn")
    _lin(sd, "fc1", params["fc1"])
    _bn(sd, "bn", params["bn"], stats["bn"])
    _lin(sd, "fc2", params["fc2"])
    return sd


# the LSTM encoders and the Dense layers of lstm and fusiontrainer (beside
# the trunk, the note LayerNorm and embedding)
_LSTMS = ("ehr_model", "lstm_fusion_layer", "daft_head")
_DENSES = ("dense_layer", "projection", "lstm_fused_cls", "fc_squeeze",
           "fc_txt", "fc_visual", "fc_skeleton", "projection_txt",
           "joint_cls", "aux_base", "aux_out")


def _baseline(params: Mapping) -> Dict[str, torch.Tensor]:
    """LSTM_MODEL and FUSIONTRAINER (JAX baselines.py:168-260): the LSTM
    encoders, the trunk ``cxr_model``, ``txtnorm``, ``txt_embedding`` and
    the denses, each under its flax name."""
    sd: Dict[str, torch.Tensor] = {}
    for key in params:
        if key in _LSTMS:
            _lstm_encoder(sd, key, params[key])
        elif key == "cxr_model":
            sd.update(swin_state_dict(params[key], "cxr_model."))
        elif key == "txtnorm":
            _ln(sd, key, params[key])
        elif key == "txt_embedding":
            _txt_embedding(sd, key, params[key])
        elif key in _DENSES:
            _lin(sd, key, params[key])
    return sd


def _feature_temporal(params: Mapping, stats: Mapping
                      ) -> Dict[str, torch.Tensor]:
    """FEATURE_TEMPORAL_V1 (JAX extras.py:186-236): the stems, the two
    encoders, ``final_ln`` and the head."""
    sd: Dict[str, torch.Tensor] = {}
    for name in ("feat_stems", "feat_bias"):
        sd[name] = _t(params[name])
    _ln(sd, "stem_ln", params["stem_ln"])
    for name in ("age_encoder", "gender_encoder"):
        _lin(sd, name, params[name])
    for name in ("instance_graph_transformer", "temporal_transformer"):
        _encoder(sd, name, params[name])
    _ln(sd, "final_ln", params["final_ln"])
    _cls_head(sd, params, stats)
    return sd


def from_jax_variables(cfg: Config, variables: Mapping
                       ) -> Dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` of ``cfg.model`` -> port
    state_dict (fp32 tensors). Raises on a leaf of either tree it does
    not carry across."""
    trees = (variables["params"], variables.get("batch_stats", {}))
    params, stats = (_Tracked(t) for t in trees)
    if cfg.model in _CROSS_TRANSFORMERS:
        sd = _cross_transformer(params, stats)
    elif cfg.model == "unimodal_transformer":
        sd = _unimodal(params, stats)
    elif cfg.model in _MULTITOKEN_MODELS:
        sd = _multitoken(params)
    elif cfg.model in _MT_MODELS:
        sd = _mt(params, stats)
    elif cfg.model in _MBT_MODELS:
        sd = _mbt(cfg, params, stats)
    elif cfg.model == "gru_d":
        sd = _gru_d(params, stats)
    elif cfg.model in ("lstm", "fusiontrainer"):
        sd = _baseline(params)
    elif cfg.model == "feature_temporal_v1":
        sd = _feature_temporal(params, stats)
    else:
        raise NotImplementedError(
            f"no weight bridge for model '{cfg.model}' yet")
    for tree, view in zip(trees, (params, stats)):
        unused = sorted(set(_leaf_paths(tree)) - view.used)
        if unused:
            raise ValueError(f"--model {cfg.model}: JAX leaves not carried "
                             f"across: {['/'.join(p) for p in unused[:8]]}"
                             f" (+{max(0, len(unused) - 8)} more)")
    return sd


def _mbt(cfg: Config, params: Mapping, stats: Mapping
         ) -> Dict[str, torch.Tensor]:
    """The MBT models: the shared stems (and ``umse_img`` / ``umse_txt``
    of noshareumse), the trunk, the fusion, ``after_concat_ln``, the
    heads (``fc_list``, or ``fc_list_{m}`` per stream), ``flexibleavg``
    and ``rmse_layer`` where the model has them."""
    sd: Dict[str, torch.Tensor] = {}
    backbone = params["backbone"]
    _umse(sd, backbone["umse"])
    for m in ("img", "txt"):
        if f"umse_{m}" in backbone:
            _umse(sd, backbone[f"umse_{m}"], f"umse_{m}.")
    if "img_enc" in backbone:
        _img(sd, backbone["img_enc"])
    _fusion(sd, "fusion_transformer", backbone["fusion_transformer"],
            len(cfg.input_types.split("_")))
    _ln(sd, "layer_norms_after_concat", params["after_concat_ln"])
    for key in params:
        if key == "fc_list" or key.startswith("fc_list_"):
            _cls_head(sd, params, stats, key)
    if "flexibleavg" in params:
        sd["flexibleavg"] = _t(params["flexibleavg"])
    if "rmse_layer" in params:
        _lin(sd, "rmse_layer", params["rmse_layer"])
    return sd


def params_from_jax(cfg: Config, tree: Mapping) -> Dict[str, torch.Tensor]:
    """A tree shaped like the JAX model's params (the params, or an
    optimizer's moments of them) -> the port's parameter names, with the
    same layout rules (buffers left out)."""
    zero = {"mean": np.zeros(1), "var": np.zeros(1)}
    stub = {k: {"bn": zero} for k, head in tree.items()
            if isinstance(head, Mapping) and "bn" in head}
    if "bn" in tree:
        # a BatchNorm at the model's root (gru_d's)
        stub["bn"] = zero
    sd = from_jax_variables(cfg, {"params": tree, "batch_stats": stub})
    return {k: v for k, v in sd.items()
            if not k.endswith(("running_mean", "running_var",
                               "num_batches_tracked"))}


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
