"""Train and eval steps of the port (counterpart of
medical_tri_modal_pilot_tpu/train/trainer.py): missing-modality codes, the
detection and classification losses, eval output selection, the LR
schedules and optimizers, and a ``Trainer`` whose ``train_step`` returns
the loss and whose ``eval_step`` returns ``(probs, loss, rmse)`` like the
JAX one.

``device_batch`` takes the loader's batches as they come: dense or in the
H2D wire format (``txt_id`` rows into a ``TxtTable`` the Trainer holds on
the device, uint8 CXR pixels, the presence-packed image rows of
``wire_pack``), and TIE streams sliced to their ``--tie-buckets`` bucket
on the host. The wire resolves on the device to exactly the dense fp32
batch (``resolve_wire``).

Tensor parallelism: ``Trainer(..., mesh=make_mesh(...))`` with mp > 1
shards the model (``parallel.mesh.shard_model``) and builds the optimizer
over this rank's shards; every rank runs the same batch and returns the
same loss and probabilities. ``state_dicts`` and ``load_state_dicts`` move
whole, reference-layout state in and out.
"""
from __future__ import annotations

import math
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import Config
from ..models.models import select_case_mean
from ..models.modules import DropoutSeeds
from ..parallel.mesh import (Mesh, gather_state_dict, shard_model,
                             shard_state_dict)
from .schedule import cosine_annealing_warmup_restarts, cosine_warmup_single

# the batch keys the train and eval steps read, and the wire format's
# (resolved on the device into "txt" and "img")
BATCH_KEYS = ("vslt", "static", "input_length", "img", "img_time", "txt",
              "txt_length", "txt_time", "missing", "target", "target_aux",
              "f_indices")
WIRE_KEYS = ("txt_id", "img_pack", "img_rows")
# k -> k / 255 in fp32, as the loader's to_tensor computes it
# (data/images.py): uint8 pixels resolve by lookup, bit for bit
U8_TO_F32 = np.arange(256, dtype=np.float32) / 255.0


def compute_missing_num(cfg: Config, missing: torch.Tensor) -> torch.Tensor:
    """missing: [B, 3] floats (vslt, img, txt; 1 = missing) -> canonical
    candidate index (reference trainer.py:53-105)."""
    img = missing[:, 1].long()
    txt = missing[:, 2].long()
    if cfg.input_types == "vslt_img_txt":
        return 2 * img + txt
    if cfg.input_types == "vslt_img":
        return img
    if cfg.input_types == "vslt_txt":
        return txt
    return torch.zeros_like(img)


# the multitoken models' loss weights (reference trainer.py:78-84): row =
# the sample's missing case, column = the head's candidate subset (tri,
# v+i, v+t, v), 1 = the subset holds a missing modality and is not trained
_MULTITOKEN_MISSING = np.array([
    [0., 0., 0., 0.],
    [1., 0., 1., 0.],
    [1., 1., 0., 0.],
    [1., 1., 1., 0.],
], dtype=np.float32)


def multitoken_targets(cfg: Config, targets: torch.Tensor) -> torch.Tensor:
    """``--multitoken 1`` under ``--fullmodal-definition`` txt1 or img1
    repeats each target twice, sample-major (JAX trainer.py:161-169); the
    train step only."""
    if cfg.multitoken and cfg.fullmodal_definition in ("txt1", "img1"):
        return torch.repeat_interleave(targets, 2, dim=0)
    return targets


def bce(logits, targets):
    """Elementwise sigmoid binary cross-entropy (optax's formula)."""
    return F.binary_cross_entropy_with_logits(logits, targets,
                                              reduction="none")


def classification_loss(cfg: Config, logits, targets, targets_aux):
    """``--model-types classification`` by ``--loss-types`` (JAX
    trainer.py:175-187): softmax cross-entropy on the integer hour bucket
    (``softmax``); BCE on the multi-hot [B, 12] target (``bces``); the
    two together, the multi-hot in ``targets_aux`` (``bceandsoftmax``);
    the root mean square error of a time to the event (``rmse``); else
    the mean BCE."""
    kind = cfg.loss_types
    if kind in ("softmax", "bceandsoftmax"):
        loss = F.cross_entropy(logits, targets.long())
        if kind == "bceandsoftmax":
            loss = loss + bce(logits, targets_aux).mean()
        return loss
    if kind == "rmse":
        return torch.sqrt(((logits - targets) ** 2).mean() + 1e-12)
    return bce(logits, targets).mean()


def _heads_loss(logits, targets, w):
    """The BCE of each head's logits [K, B] against the target, weighted
    by w [K, B] and averaged over the weight."""
    losses = bce(logits, targets[None].expand_as(logits))
    return (losses * w).sum() / w.sum().clamp_min(1.0)


def compute_loss(cfg: Config, logits, rmse, targets, targets_aux,
                 missing=None, missing_num=None, multi_head: bool = False):
    """The loss (JAX trainer.py:172-209): under ``--model-types
    classification`` ``classification_loss``. Detection: for a model with
    one head per missing case (``multi_head``, logits [4, B]) the BCE of
    each head against the target, averaged over the heads whose candidate
    subset the sample's missing case (``missing_num``) holds; for
    ``*mbt_vnoshnoavgtr`` (logits [3, B], one per stream) the BCE of each
    head weighted by its stream's presence (``missing`` [B, 3]); else the
    mean BCE, plus the aux-rmse term on positive samples when
    configured."""
    if cfg.model_types == "classification":
        return classification_loss(cfg, logits, targets, targets_aux)
    if multi_head:
        if missing_num is None:
            raise ValueError(f"--model {cfg.model}: the loss needs "
                             "missing_num")
        table = torch.as_tensor(_MULTITOKEN_MISSING, device=logits.device)
        return _heads_loss(logits, targets,
                           1.0 - table[missing_num.long()].T)   # [4, B]
    if "mbt_vnoshnoavgtr" in cfg.model:
        return _heads_loss(logits, targets, 1.0 - missing.T)     # [3, B]
    loss = bce(logits, targets).mean()
    if rmse is not None and "rmse" in cfg.auxiliary_loss_type:
        err = (rmse - targets_aux) ** 2
        pos = targets == 1
        rmse_loss = torch.sqrt(torch.where(pos, err, 0.0).sum()
                               / pos.sum().clamp_min(1))
        loss = loss + torch.nan_to_num(rmse_loss)
    return loss


def select_eval_output(cfg: Config, logits, missing_num,
                       multi_head: bool = False):
    """Eval-time output selection (JAX trainer.py:212-225): a model with
    one head per missing case (``multi_head``) gives, per sample, the head
    of its case from [4, B]; ``*mbt_vnoshnoavgtr`` the mean of its
    available streams' heads from [3, B]; single-output models return
    their logits as they are."""
    if multi_head:
        return logits.gather(0, missing_num.long()[None])[0]
    if "mbt_vnoshnoavgtr" in cfg.model:
        return select_case_mean(logits, missing_num)
    return logits


def build_schedule(cfg: Config, iters_per_epoch: int) -> Callable:
    """The LR schedule of a run (JAX trainer.py:112-122)."""
    max_lr = cfg.lr_init * math.sqrt(cfg.batch_size)
    if cfg.lr_scheduler == "CosineAnnealing":
        return cosine_annealing_warmup_restarts(
            first_cycle_steps=max(cfg.t_0 * iters_per_epoch, 2),
            max_lr=max_lr, min_lr=1e-6,
            warmup_steps=cfg.t_up * iters_per_epoch,
            gamma=cfg.gamma, cycle_mult=float(cfg.t_mult))
    return cosine_warmup_single(
        total_steps=max(cfg.epochs * iters_per_epoch, 2), max_lr=max_lr,
        min_lr=1e-6, warmup_steps=cfg.t_up * iters_per_epoch)


class Optimizer:
    """adamw, adam or sgd with momentum, each optionally with LARS trust-
    ratio scaling chained before it (``--optim {adamw,adam,sgd}[_lars]``,
    JAX trainer.py:140-154 over optax). The update k (from 0) runs at the
    learning rate the caller passes, ``schedule(k)``, as optax's count
    does. torch.optim computes the same updates as optax: AdamW's decay
    p (1 - lr wd) equals optax's -lr (adam + wd p); SGD's first momentum
    buffer is the gradient, as optax's trace of zeros plus it."""

    def __init__(self, cfg: Config, params: List[torch.nn.Parameter],
                 split: Optional[List[bool]] = None,
                 mesh: Optional[Mesh] = None):
        """``split``: per parameter, whether it is a tensor-parallel shard
        (LARS then takes its norms over the model group of ``mesh``)."""
        kind = cfg.optim.replace("_lars", "")
        self.lars = cfg.optim.endswith("_lars")
        self.params = list(params)
        self.split = split if split is not None and any(split) else None
        self.mesh = mesh
        if kind == "adamw":
            self.opt = torch.optim.AdamW(self.params, lr=0.0,
                                         weight_decay=cfg.weight_decay,
                                         eps=1e-8)
        elif kind == "adam":
            self.opt = torch.optim.Adam(self.params, lr=0.0, eps=1e-8)
        elif kind == "sgd":
            self.opt = torch.optim.SGD(self.params, lr=0.0,
                                       momentum=cfg.momentum)
        else:
            raise ValueError(f"--optim {cfg.optim}: not an optimizer")

    @torch.no_grad()
    def _trust_ratio(self) -> None:
        """optax.scale_by_trust_ratio(): g *= |p| / |g| per tensor, 1 where
        either norm is 0. A tensor-parallel shard takes the norms of the
        whole tensor: its squares summed over the model group."""
        sq = torch.stack([torch.stack([p.square().sum(),
                                       p.grad.square().sum()])
                          for p in self.params])
        if self.split is not None:
            mask = torch.tensor(self.split, device=sq.device)[:, None]
            whole = torch.where(mask, sq, 0.0)
            torch.distributed.all_reduce(whole,
                                         group=self.mesh.model_group)
            sq = torch.where(mask, whole, sq)
        norms = sq.sqrt()
        for p, (pn, gn) in zip(self.params, norms):
            ratio = torch.where((pn == 0) | (gn == 0), 1.0, pn / gn)
            p.grad.mul_(ratio)

    def step(self, lr: float) -> None:
        # a parameter the loss does not reach (the last layer's non-vslt
        # streams) has a zero gradient in optax, which still decays it and
        # moves its moments; torch.optim would skip a None gradient
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.lars:
            self._trust_ratio()
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def state_dict(self):
        return self.opt.state_dict()

    def load_state_dict(self, state) -> None:
        self.opt.load_state_dict(state)


def build_optimizer(cfg: Config, model: torch.nn.Module,
                    split: Optional[Dict[str, int]] = None,
                    mesh: Optional[Mesh] = None) -> Optimizer:
    """``--optim`` over the parameters that take a gradient (JAX
    trainer.py:140-154 with its _trainable_mask: a frozen trunk, whose
    parameters the model builds with requires_grad False, takes no update,
    decay or moment state). ``split``: the tensor-parallel shards by name
    (shard_model), over the model group of ``mesh``."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    split = split or {}
    return Optimizer(cfg, [p for _, p in named],
                     [n in split for n, _ in named], mesh)


def resolve_buckets(cfg: Config) -> Tuple[int, ...]:
    """The TIE stream-length buckets of ``--tie-buckets`` (JAX
    trainer.py:337-357): "auto" is 256 and 512 below --TIE-len, a list
    its entries below it, each followed by --TIE-len; () when off or not a
    TIE/QIE run."""
    spec = cfg.tie_buckets
    if cfg.vslt_type not in ("TIE", "QIE") or spec in ("off", ""):
        return ()
    if spec == "auto":
        cand = [b for b in (256, 512) if b < cfg.tie_len]
    else:
        cand = sorted({int(x) for x in spec.split(",")
                       if x.strip() and 0 < int(x) < cfg.tie_len})
    return tuple(cand) + (cfg.tie_len,) if cand else ()


def bucket_batch(buckets: Tuple[int, ...], batch: Dict[str, np.ndarray]
                 ) -> Dict[str, np.ndarray]:
    """Slice a batch's TIE stream to the smallest bucket that holds its
    longest sample (JAX trainer.py:359-376). TIE rows are time-ordered
    with the padding at the end, and every op downstream masks by
    input_length, so the outputs do not depend on the bucket. No-op when
    bucketing is off, the batch is already sliced or not TIE-shaped."""
    if not buckets:
        return batch
    v = batch.get("vslt")
    if (v is None or v.ndim < 3 or v.shape[1] != buckets[-1]
            or "input_length" not in batch):
        return batch
    ml = int(np.max(np.asarray(batch["input_length"])))
    bucket = next((bk for bk in buckets if ml <= bk), buckets[-1])
    if bucket >= v.shape[1]:
        return batch
    return dict(batch, vslt=v[:, :bucket])


def _moment(v) -> bool:
    """An optimizer state entry shaped like its parameter (a moment, not
    the step count)."""
    return torch.is_tensor(v) and v.dim() > 0


class Trainer:
    """Holds the model on its device and runs the train and eval steps.

    ``eval_only=False`` builds the optimizer over the trainable parameters
    and the LR schedule. ``train_step`` runs update ``self.step`` (from 0)
    at ``schedule(self.step)``; its dropout draws the seeds of
    ``DropoutSeeds(seed, self.step)``, so a run resumed at a step draws the
    masks it would have drawn."""

    def __init__(self, cfg: Config, model: torch.nn.Module,
                 device: torch.device, eval_only: bool = True,
                 iters_per_epoch: int = 1, seed: int = 0,
                 mesh: Optional[Mesh] = None, txt_table=None):
        """``mesh``: the process mesh (parallel.mesh.make_mesh); with mp > 1
        the model is cut to this rank's tensor-parallel shard here.
        ``txt_table``: the loader's ``data.txt_table.TxtTable``, whose rows
        go to the device once, in the model's compute dtype (its first use
        of the notes casts them to it, so bf16 rows give the dense batch's
        result bit for bit)."""
        mp = 1 if mesh is None else mesh.mp
        if max(cfg.mp_size, 1) != mp:
            raise ValueError(f"--mp-size {cfg.mp_size} against a mesh of "
                             f"{mp} model ranks: build the mesh with "
                             "parallel.mesh.make_mesh after "
                             "parallel.distributed.maybe_init_distributed")
        if mp > 1 and cfg.model != "tri_mbt_vsltcls":
            raise NotImplementedError(
                f"--model {cfg.model} under --mp-size {mp}: tensor "
                "parallelism covers tri_mbt_vsltcls; the other models are "
                "ROADMAP Queue 1 item 8")
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = mesh
        self.split = {} if mesh is None else shard_model(model, mesh)
        self.model = model.to(self.device).eval()
        # one output per missing case, [4, B] (models.py::MultitokenBase)
        self.multi_head = getattr(model, "MULTI_HEAD", False)
        self.seed = int(seed)
        self.step = 0
        self.schedule = build_schedule(cfg, max(iters_per_epoch, 1))
        self.optimizer = None if eval_only else build_optimizer(
            cfg, self.model, self.split, mesh)
        self.buckets = resolve_buckets(cfg)
        # the packed image wire (JAX trainer.py:280-286): a batch's present
        # image rows, uint8, at the static capacity of --img-pack-frac; one
        # process (the pack axis is not data-shardable in the JAX package)
        self.wire_pack_c = None
        if (cfg.img_wire_pack and cfg.img_wire_u8
                and (mesh is None or mesh.dp * mesh.mp == 1)
                and 0.0 < cfg.img_pack_frac < 1.0):
            self.wire_pack_c = min(
                cfg.batch_size,
                int(math.ceil(cfg.batch_size * cfg.img_pack_frac)) + 1)
        self.txt_table = None
        if txt_table is not None:
            dt = torch.bfloat16 if cfg.precision == "bf16" else torch.float32
            self.txt_table = torch.as_tensor(txt_table.rows).to(
                self.device, dt)
        self._u8 = torch.as_tensor(U8_TO_F32).to(self.device)

    def _param_names(self) -> List[str]:
        names = {id(p): n for n, p in self.model.named_parameters()}
        return [names[id(p)] for p in self.optimizer.params]

    def state_dicts(self) -> Tuple[Dict[str, torch.Tensor], Optional[dict]]:
        """(model state_dict, optimizer state_dict) of the whole model in
        the single-process layout, on the CPU; under tensor parallelism
        gathered from the model group (a collective: every rank calls
        it)."""
        model_sd = self.model.state_dict()
        opt_sd = None if self.optimizer is None else \
            self.optimizer.state_dict()
        if self.split:
            model_sd = gather_state_dict(model_sd, self.split, self.mesh)
            if opt_sd is not None:
                names = self._param_names()
                state = {}
                for i, st in opt_sd["state"].items():
                    dim = self.split.get(names[i])
                    state[i] = st if dim is None else gather_state_dict(
                        st, {k: dim for k, v in st.items() if _moment(v)},
                        self.mesh)
                opt_sd = dict(opt_sd, state=state)
        # copies even of CPU tensors: the saver writes them from a thread
        # while the steps go on updating the live ones in place
        cpu = (lambda t: t.detach().to("cpu", copy=True)
               if torch.is_tensor(t) else t)
        model_sd = {k: cpu(v) for k, v in model_sd.items()}
        if opt_sd is not None:
            opt_sd = dict(opt_sd, state={
                i: {k: cpu(v) for k, v in st.items()}
                for i, st in opt_sd["state"].items()})
        return model_sd, opt_sd

    def load_state_dicts(self, model_sd: Dict[str, torch.Tensor],
                         opt_sd: Optional[dict] = None) -> None:
        """Load whole, single-process-layout state (``state_dicts``' or a
        checkpoint's); under tensor parallelism this rank's shard of it."""
        if self.split:
            mp, index = self.mesh.mp, self.mesh.model_index
            model_sd = shard_state_dict(model_sd, mp, index)
            if opt_sd is not None:
                names = self._param_names()
                opt_sd = dict(opt_sd, state={
                    i: {k: v.chunk(mp, self.split[names[i]])[index].clone()
                        if _moment(v) and names[i] in self.split else v
                        for k, v in st.items()}
                    for i, st in opt_sd["state"].items()})
        self.model.load_state_dict(model_sd, strict=True)
        if self.optimizer is not None and opt_sd is not None:
            self.optimizer.load_state_dict(opt_sd)

    def wire_pack(self, batch: Dict[str, np.ndarray]
                  ) -> Dict[str, np.ndarray]:
        """The packed image wire on the host (JAX trainer.py:378-399):
        replace a dense uint8 ``img`` whose present rows fit the capacity
        with ``img_pack`` [C, ...] and ``img_rows`` [C] (padding rows index
        B, past the batch, and are dropped on the device). No-op when off,
        fp32, or over the capacity (the dense wire then)."""
        C = self.wire_pack_c
        img = batch.get("img")
        if (C is None or not isinstance(img, np.ndarray)
                or img.dtype != np.uint8 or "missing" not in batch):
            return batch
        rows = np.nonzero(np.asarray(batch["missing"])[:, 1] == 0.0)[0]
        if len(rows) > C:
            return batch
        pack = np.zeros((C,) + img.shape[1:], np.uint8)
        pack[:len(rows)] = img[rows]
        ids = np.full((C,), img.shape[0], np.int32)
        ids[:len(rows)] = rows
        out = {k: v for k, v in batch.items() if k != "img"}
        out["img_pack"] = pack
        out["img_rows"] = ids
        return out

    def resolve_wire(self, b: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """The wire format on the device (JAX trainer.py:426-448): ``txt``
        gathered from the table by ``txt_id``, uint8 pixels to k / 255 in
        fp32, packed image rows scattered into a zero batch. The result is
        the dense fp32 batch the loader would have sent, bit for bit."""
        b = dict(b)
        if "txt_id" in b:
            if self.txt_table is None:
                raise ValueError("a txt_id batch needs the Trainer's "
                                 "txt_table (data.txt_table.build_txt_table)")
            b["txt"] = self.txt_table.index_select(
                0, b.pop("txt_id").long()).float()
        if "img_pack" in b:
            pack = self._u8[b.pop("img_pack").long()]
            rows = b.pop("img_rows").long()
            B = b["missing"].shape[0]
            # one spare row takes the padding rows' (zero) writes
            img = pack.new_zeros((B + 1,) + pack.shape[1:])
            b["img"] = img.index_copy_(0, rows, pack)[:B]
        elif "img" in b and b["img"].dtype == torch.uint8:
            b["img"] = self._u8[b["img"].long()]
        return b

    def device_batch(self, batch: Dict[str, np.ndarray]
                     ) -> Dict[str, torch.Tensor]:
        """A host batch on the device: its TIE stream cut to its bucket and
        its images packed on the host, copied, and the wire resolved."""
        batch = self.wire_pack(bucket_batch(self.buckets, batch))
        with warnings.catch_warnings():
            # replayed eval batches are read-only (data.pipeline.
            # ReplayLoader); the steps never write into a batch
            warnings.filterwarnings("ignore", "The given NumPy array is not "
                                    "writable")
            b = {k: torch.as_tensor(np.asarray(batch[k])).to(self.device)
                 for k in BATCH_KEYS + WIRE_KEYS if k in batch}
        return self.resolve_wire(b)

    def train_step(self, batch: Dict[str, np.ndarray]) -> float:
        """One optimizer step on ``batch``: the loss (JAX trainer.py:
        450-480), its gradients, the update at ``schedule(step)``, and the
        BatchNorm running statistics. Returns the loss."""
        if self.optimizer is None:
            raise RuntimeError("construct the Trainer with eval_only=False "
                               "to train")
        cfg = self.cfg
        self.model.train()
        b = self.device_batch(batch)
        missing_num = compute_missing_num(cfg, b["missing"])
        logits, rmse, aux = self.model(b, missing_num,
                                       DropoutSeeds(self.seed, self.step))
        loss = compute_loss(cfg, logits.float(),
                            None if rmse is None else rmse.float(),
                            multitoken_targets(cfg, b["target"].float()),
                            b["target_aux"].float(), b["missing"],
                            missing_num, self.multi_head)
        if aux is not None:
            # a model-computed auxiliary loss (JAX trainer.py:463-468)
            loss = loss + cfg.auxiliary_loss_weight * aux.float()
        self.optimizer.zero_grad()
        loss.backward()
        self.optimizer.step(self.current_lr())
        self.step += 1
        self.model.eval()
        return float(loss.detach())

    def current_lr(self) -> float:
        """The learning rate of the next update."""
        return self.schedule(self.step)

    def eval_step(self, batch: Dict[str, np.ndarray]
                  ) -> Tuple[np.ndarray, float, Optional[float]]:
        """Returns ``(probs, loss, rmse)``; rmse is None unless the run has
        an aux-rmse head (``--auxiliary-loss-type rmse``)."""
        cfg = self.cfg
        with torch.inference_mode():
            b = self.device_batch(batch)
            missing_num = compute_missing_num(cfg, b["missing"])
            logits, rmse, _ = self.model(b, missing_num)
            logits = logits.float()
            out = select_eval_output(cfg, logits, missing_num,
                                     self.multi_head)
            if cfg.model_types == "classification":
                loss = compute_loss(cfg, logits, rmse, b["target"].float(),
                                    b["target_aux"].float())
            else:
                # detection: BCE on the selected output, no aux term
                loss = bce(out, b["target"].float()).mean()
            probs = torch.sigmoid(out)
            eval_rmse = None
            if (rmse is not None and "rmse" in cfg.auxiliary_loss_type
                    and cfg.model_types == "detection"):
                err = (rmse.float() - b["target_aux"]) ** 2
                pos = b["target"] == 1
                eval_rmse = torch.nan_to_num(torch.sqrt(
                    torch.where(pos, err, 0.0).sum()
                    / pos.sum().clamp_min(1)))
            return (probs.cpu().numpy(), float(loss),
                    None if eval_rmse is None else float(eval_rmse))
