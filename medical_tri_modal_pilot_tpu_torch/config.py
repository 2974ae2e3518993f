"""CLI + configuration system.

The port's own copy of ``medical_tri_modal_pilot_tpu/config.py``, kept
identical in behaviour (tests/test_torch_copies.py compares the two).

Keeps the exact argparse surface of the reference (control/config.py:1-159)
so reference experiment commands run unchanged, but parses it into a frozen
``Config`` dataclass instead of a mutable global namespace. Fields that the
reference monkey-patched onto ``args`` at runtime (``feature_means``,
``vslt_mask``, ``device`` — data_preprocess.py:43,80-84, 2_train.py:65) are
computed once here as derived attributes.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np

from . import constants


def build_parser() -> argparse.ArgumentParser:
    """The reference CLI surface (control/config.py:10-153), verbatim flags."""
    parser = argparse.ArgumentParser()

    # General
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--seed-list', type=int, nargs='+', default=[412, 1004, 2023])
    parser.add_argument('--device', type=int, default=1, nargs='+')
    parser.add_argument('--cpu', type=int, default=0)
    parser.add_argument('--num-workers', type=int, default=5)
    parser.add_argument('--gpus', type=int, default=1)
    parser.add_argument('--reset', default=False, action='store_true')
    parser.add_argument('--project-name', type=str, default="small1")
    parser.add_argument('--checkpoint', '-cp', type=bool, default=False)
    parser.add_argument('--flexconst', type=float, default=1)

    parser.add_argument('--prediction-range', type=int, default=12)
    parser.add_argument('--min-inputlen', type=int, default=3)
    parser.add_argument('--window-size', type=int, default=24)
    parser.add_argument('--vslt-type', type=str, default="TIE",
                        choices=["carryforward", "TIE", "QIE"])
    parser.add_argument('--realtime', type=int, default=1, choices=[0, 1])
    parser.add_argument('--multiimages', type=int, default=0, choices=[0, 1])
    parser.add_argument('--TIE-len', type=int, default=1000)
    parser.add_argument('--ar-lowerbound', type=float, default=0.7)
    parser.add_argument('--ar-upperbound', type=float, default=1.3)

    parser.add_argument('--input-types', type=str, default="vslt",
                        choices=["vslt", "vslt_img", "vslt_txt", "vslt_img_txt"])
    parser.add_argument('--output-type', type=str, default="mortality",
                        choices=['mortality', 'vasso', 'intubation', 'cpr', 'transfer'])
    parser.add_argument('--predict-type', type=str, default="within",
                        choices=["within", "multi_task_within", "multi_task_range", "seq_pretrain"])
    parser.add_argument('--modality-inclusion', type=str, default="train-full_test-full",
                        choices=['train-full_test-full', 'train-missing_test-missing',
                                 'train-full_test-missing'])
    parser.add_argument('--fullmodal-definition', type=str, default="txt1_img1",
                        choices=["txt1_img1", "img1", "txt1"])

    # Data paths
    parser.add_argument('--train-data-path', type=str, default="./data/sample_data/train")
    parser.add_argument('--test-data-path', type=str, default="./data/sample_data/test")
    parser.add_argument('--dir-result', type=str, default="./results")
    parser.add_argument('--image-data-path', type=str, default="./data/images/")

    # Data parameters
    parser.add_argument('--cross-fold-val', type=int, default=0, choices=[1, 0])
    parser.add_argument('--val-data-ratio', type=float, default=0.1)
    parser.add_argument('--imgtxt-time', type=int, default=0, choices=[0, 1])

    # Training
    parser.add_argument('--missing-exhaustive', type=int, default=0, choices=[0, 1])
    parser.add_argument('--epochs', type=int, default=50)
    parser.add_argument('--batch-size', type=int, default=32)
    parser.add_argument('--l2-coeff', type=float, default=0.002)
    parser.add_argument('--dropout', type=float, default=0.1)
    parser.add_argument('--activation', choices=['selu', 'relu'], default='relu', type=str)
    parser.add_argument('--optim', type=str, default='adamw',
                        choices=['sgd', 'sgd_lars', 'adam', 'adam_lars', 'adamw', 'adamw_lars'])
    parser.add_argument('--lr-scheduler', type=str, default="CosineAnnealing",
                        choices=["CosineAnnealing", "Single"])
    parser.add_argument('--lr-init', type=float, default=1e-3)
    parser.add_argument('--t_0', '-tz', type=int, default=50)
    parser.add_argument('--t_mult', '-tm', type=int, default=2)
    parser.add_argument('--t_up', '-tup', type=int, default=5)
    parser.add_argument('--gamma', '-gam', type=float, default=0.5)
    parser.add_argument('--momentum', '-mo', type=float, default=0.9)
    parser.add_argument('--weight_decay', '-wd', type=float, default=1e-6)

    parser.add_argument('--patient-time', default=False)
    parser.add_argument('--threshold', type=float, default=0.5)
    parser.add_argument('--output-dim', type=int, default=1)

    # Text transformer
    parser.add_argument('--txt-num-layers', type=int, default=8)
    parser.add_argument('--txt-dropout', type=float, default=0.1)
    parser.add_argument('--txt-model-dim', type=int, default=256)
    parser.add_argument('--txt-num-heads', type=int, default=4)
    parser.add_argument('--txt-classifier-nodes', type=int, default=64)

    parser.add_argument('--txt-tokenization', type=str, default="bert",
                        choices=["word", "character", "bpe", "bert"])
    parser.add_argument('--berttype', type=str, default="biobert", choices=["biobert", "bert"])
    parser.add_argument('--biobert-path', type=str, default="./data/mimic4_embeddings.h5")
    parser.add_argument('--character-token-max-length', type=int, default=512)
    parser.add_argument('--word-token-max-length', type=int, default=128)
    parser.add_argument('--bpe-token-max-length', type=int, default=256)
    parser.add_argument('--bert-token-max-length', type=int, default=128)

    # VSLT model
    parser.add_argument('--enc-depth', type=int, default=3, choices=[1, 2, 3])
    parser.add_argument('--hidden-size', type=int, default=256)
    parser.add_argument('--transformer-dim', type=int, default=256)
    parser.add_argument('--transformer-num-layers', type=int, default=6)
    parser.add_argument('--transformer-num-head', type=int, default=4)

    # Image model
    parser.add_argument('--resnet-num-layers', type=int, default=18, choices=[18, 34, 50])
    parser.add_argument('--vit-num-layers', type=int, default=8, choices=[4, 8, 10, 12])
    parser.add_argument('--vit-patch-size', type=int, default=16, choices=[8, 16])

    parser.add_argument('--img-model-type', type=str, default="swin",
                        choices=["resnet18", "resnet50", "swin", "vit", "maxvit"])
    parser.add_argument('--img-pretrain', type=str, default="Yes", choices=["No", "Yes"])
    parser.add_argument('--img-pretrain-path', type=str, default=None,
                        help='converted torchvision weights for the frozen '
                             'image encoder (tools/convert_torchvision.py); '
                             'replaces the reference\'s NFS checkpoint load '
                             '(tri_mbt_vsltcls.py:95-100)')
    parser.add_argument('--image-size', type=int, default=224, choices=[224, 512])
    parser.add_argument('--image-train-type', type=str, default="resize_affine_crop",
                        choices=["random", "resize", "resize_crop", "resize_affine_crop", "randaug"])
    parser.add_argument('--image-test-type', type=str, default="resize_crop",
                        choices=["center", "resize", "resize_crop", "resize_larger"])
    parser.add_argument('--image-norm-type', type=str, default="HE", choices=["HE", "CLAHE"])

    # MBT
    parser.add_argument('--residual-bottlenecks', type=int, default=0, choices=[0, 1])
    parser.add_argument('--mbt-bottlenecks-n', type=int, default=4)
    parser.add_argument('--mbt-fusion-startIdx', type=int, default=0)
    parser.add_argument('--mbt-only-vslt', type=int, default=0)

    # Loss
    parser.add_argument('--model-types', type=str, default="detection",
                        choices=["detection", "classification"])
    parser.add_argument('--loss-types', type=str, default="bce",
                        choices=["bceandsoftmax", "softmax", "bces", "bce", "wkappa", "rmse"])
    parser.add_argument('--auxiliary-loss-input', type=str, default=None,
                        choices=[None, "directInput", "encOutput"])
    parser.add_argument('--auxiliary-loss-type', type=str, default="None",
                        choices=["None", "rmse", "tdecoder", "tdecoder_rmse"])
    parser.add_argument('--auxiliary-loss-weight', type=float, default=1.0)

    parser.add_argument('--mandatory-vitalsign-labtest', type=str, nargs='+',
                        default=['HR', 'RR', 'BT', 'SBP', 'DBP', 'Sat'])
    parser.add_argument('--vitalsign-labtest', type=str, nargs='+',
                        default=['HR', 'RR', 'BT', 'SBP', 'DBP', 'Sat', 'Hematocrit', 'PLT',
                                 'WBC', 'Bilirubin', 'pH', 'HCO3', 'Creatinine', 'Lactate',
                                 'Potassium', 'Sodium'])
    parser.add_argument('--model', type=str, default="gru_d")

    # Logging / sampling
    parser.add_argument('--log-iter', type=int, default=10)
    parser.add_argument('--nonPatNegSampleN', type=int, default=4)
    parser.add_argument('--PatNegSampleN', type=int, default=1)
    parser.add_argument('--PatPosSampleN', type=int, default=5)
    parser.add_argument('--best', default=True, action='store_true')
    parser.add_argument('--last', default=False, action='store_true')

    parser.add_argument('--fuse-baseline', type=str, default=None,
                        choices=["Medfuse", "MMTM", "DAFT", "Retain", "Multi"])
    parser.add_argument('--mmtm-ratio', type=float, default=4)
    parser.add_argument('--daft_activation', type=str, default='linear')
    parser.add_argument('--fusion-type', type=str, default='fused_ehr')

    # Eval-time observed-modality dropout (3_test.py)
    parser.add_argument('--image-observed-prop', type=int, default=100,
                        choices=[10, 30, 50, 70, 90, 100])
    parser.add_argument('--text-observed-prop', type=int, default=100,
                        choices=[10, 30, 50, 70, 90, 100])

    # Flags the reference declares but comments out (control/config.py:13,
    # 73-79). --multitoken is nonetheless read by live trainer code
    # (builder/trainer/trainer.py:57-66: bimodal train targets repeated 2x)
    # so it has behavior here; the other four have no reader anywhere in
    # the reference and are accepted-but-inert for command compatibility.
    parser.add_argument('--multitoken', type=int, default=0)
    parser.add_argument('--collate', type=int, default=2)
    parser.add_argument('--quantization', type=bool, default=False)
    parser.add_argument('--show-roc', type=bool, default=False)
    parser.add_argument('--usepe', type=bool, default=False)

    # --- TPU-native extensions (not in reference; all have safe defaults) ---
    parser.add_argument('--precision', type=str, default='bf16', choices=['bf16', 'fp32'],
                        help='activation precision; params/optimizer stay fp32')
    parser.add_argument('--use-pallas', type=int, default=1,
                        choices=[0, 1, 2],
                        help='use Pallas fused kernels on TPU (XLA fallback '
                             'otherwise); 2 forces them on any backend via '
                             'pallas interpret mode (slow — e2e kernel-'
                             'dispatch testing on CPU)')
    parser.add_argument('--worker-type', type=str, default='auto',
                        choices=['auto', 'thread', 'process', 'native'],
                        help='data-loader worker pool: "auto" (default) '
                             'resolves to "native" when the C++ TIE batch '
                             'assembler is built (native/libtie_assembler'
                             '.so — measured ~45%% faster host epochs) and '
                             'to "thread" otherwise; GIL-releasing threads; '
                             'forked processes (the reference DataLoader '
                             'model, data_preprocess.py:89-95); or threads '
                             '+ the C++ assembler for the TIE '
                             'window-assembly hot path')
    parser.add_argument('--debug-nans', type=int, default=0, choices=[0, 1],
                        help='enable jax_debug_nans — the TPU-native analog '
                             'of the reference\'s always-on '
                             'torch.autograd.set_detect_anomaly (2_train.py:31)')
    parser.add_argument('--dp-size', type=int, default=0,
                        help='data-parallel mesh size; 0 = all local devices')
    parser.add_argument('--prng', type=str, default='auto',
                        choices=['auto', 'threefry2x32', 'rbg'],
                        help='dropout PRNG: threefry2x32 (jax default, '
                             'reproducible across backends) or rbg (XLA '
                             'RngBitGenerator, much cheaper on TPU; '
                             'deterministic per machine+version). auto = '
                             'rbg on TPU, threefry elsewhere')
    parser.add_argument('--remat', type=int, default=0, choices=[0, 1],
                        help='rematerialize encoder layers in the backward '
                             '(jax.checkpoint): ~O(1) resident layer '
                             'activations instead of O(n_layers), for '
                             'larger batches / --train-multi-k super-batches')
    parser.add_argument('--mp-size', type=int, default=0,
                        help='tensor (model) parallel mesh size; >1 builds a '
                             '2-D (data, model) mesh and shards the '
                             'transformer FFN/attention matmuls over it '
                             '(parallel/mesh.py)')
    parser.add_argument('--dist-coordinator', type=str, default='',
                        help='multi-host rendezvous: "host:port" for an '
                             'explicit coordinator, "auto" for '
                             'jax.distributed.initialize() cluster '
                             'auto-detection (TPU pods). Empty = '
                             'single-process (parallel/distributed.py)')
    parser.add_argument('--dist-num-processes', type=int, default=-1,
                        help='total process count for --dist-coordinator '
                             'host:port rendezvous (-1 = from env/auto)')
    parser.add_argument('--dist-process-id', type=int, default=-1,
                        help='this process\'s rank for --dist-coordinator '
                             'host:port rendezvous (-1 = from env/auto)')
    parser.add_argument('--ckpt-backend', type=str, default='pickle',
                        choices=['pickle', 'orbax'],
                        help='checkpoint serialization: single-file pickle '
                             '(reference .pth layout) or orbax PyTree dirs')
    parser.add_argument('--checkpoint-every', type=int, default=0,
                        help='also save a "last" checkpoint every N steps (0 = per-eval only)')
    parser.add_argument('--profile-dir', type=str, default=None,
                        help='if set, write a jax.profiler trace of a few training steps here')
    parser.add_argument('--resume', type=str, default='none',
                        choices=['none', 'auto', 'best', 'last'],
                        help='restart behavior: auto = discover and restore '
                             'the newest checkpoint for this fold/seed '
                             '(crash recovery without operator flags); '
                             'best/last = explicit kind (equivalent to the '
                             "reference's --checkpoint --best/--last, "
                             '2_train.py:86-107)')
    parser.add_argument('--img-pack', type=int, default=-1, choices=[-1, 0, 1],
                        help='presence-pack the frozen image trunk: run swin '
                             'only on rows that actually carry an image '
                             '(packed to a static capacity; missing rows '
                             'share one zero-image row). -1 = auto (on for '
                             'missing-modality regimes with a frozen trunk)')
    parser.add_argument('--img-pack-frac', type=float, default=-1.0,
                        help='static packed capacity as a fraction of the '
                             'image-row count; batches with more present '
                             'images than capacity fall back in-graph to the '
                             'full-batch trunk (lax.cond). -1 = auto: derived '
                             'from the train sampler distribution at loader '
                             'build (data/pipeline.py:auto_img_pack_frac; '
                             '0.5 when no loader statistics exist)')
    parser.add_argument('--train-multi-k', type=int, default=0,
                        help='optimizer steps per device dispatch (lax.scan '
                             'super-batches, amortizes host->device dispatch '
                             'latency); 0 = auto (4 for TIE/QIE on TPU, else 1)')
    parser.add_argument('--tie-buckets', type=str, default="auto",
                        help='static TIE stream-length buckets: each '
                             'train/eval batch is sliced (before device '
                             'transfer) to the smallest bucket >= its max '
                             'input_length, so short batches execute and '
                             'transfer proportionally less — one XLA '
                             'compilation per bucket. "auto" = 256,512,'
                             'TIE_len (TIE/QIE only); "off" disables; or '
                             'comma ints. Padding rows are fully masked, so '
                             'outputs are bucket-invariant '
                             '(tests/test_tie_buckets.py)')
    parser.add_argument('--length-rebatch', type=int, default=0,
                        help='pool N consecutive train batches, stable-sort '
                             'their samples by TIE input_length and '
                             're-chunk, so --tie-buckets fires on the '
                             'sorted prefix batches (data/pipeline.py::'
                             'length_rebatch). Changes batch composition '
                             'only (same per-pool sample multiset); '
                             '0/1 = off (reference batch order). Opt-in for '
                             'TRAINING on purpose: it reorders the '
                             'class-balanced sampler stream, so SGD sees '
                             'length-correlated batches — a bounded but '
                             'real deviation from the reference regime. '
                             'Eval has no such coupling; see '
                             '--eval-length-rebatch')
    parser.add_argument('--eval-length-rebatch', type=int, default=8,
                        help='same length-sorted re-chunking for the '
                             'validation/test loops, where sample order is '
                             'irrelevant (metrics aggregate per-sample '
                             'probs+targets carried in each batch, and '
                             'equal-size batches make the mean-of-batch-'
                             'losses order-invariant) — short batches hit '
                             'the small --tie-buckets compilations. '
                             'Default ON (8 pooled batches); 0/1 = off')
    parser.add_argument('--image-cache-mb', type=int, default=256,
                        help='byte budget (MB) for the host decoded-image '
                             'LRU: caches each CXR\'s deterministic '
                             'transform prefix (decode+equalize+fixed '
                             'resize) so warm epochs only pay the random '
                             'augment. 0 disables. Bit-identical outputs.')
    parser.add_argument('--dir-root', type=str, default="",
                        help='root under which builder/data/text/'
                             'textDataset token files are resolved '
                             '(reference derives this from cwd, '
                             'control/config.py:155; additive flag so '
                             'fixture sets can carry their own token '
                             'files). "" keeps the reference cwd '
                             'behavior.')
    parser.add_argument('--image-cache-dir', type=str, default="",
                        help='persistent on-disk second level under the '
                             'decoded-image LRU (.npy per image prefix), '
                             'shared across worker processes and runs — '
                             'the cold first epoch pays each jpeg decode '
                             'once EVER instead of once per worker per '
                             'run. Bit-identical outputs. "" disables.')
    parser.add_argument('--txt-device-table-mb', type=int, default=512,
                        help='HBM budget (MB) for the device-resident '
                             'BioBERT embedding table: unique note '
                             'embeddings ship to the device ONCE and each '
                             'batch carries int32 row ids instead of the '
                             'dense [128,768] fp32 payload (25 MB/batch '
                             'at B=64); the jitted step gathers rows '
                             'in-graph, bit-identically (data/'
                             'txt_table.py). Corpora whose unique-note '
                             'table exceeds the budget fall back to '
                             'streaming automatically. 0 disables.')
    parser.add_argument('--img-wire-u8', type=int, default=1,
                        help='ship CXR pixels host->device as uint8 and '
                             'divide by 255 in-graph (4x fewer bytes). '
                             'Bit-exact: to_tensor pixels are k/255 fp32 '
                             '(data/images.py:117), so the uint8 round '
                             'trip reproduces identical fp32 values. '
                             '0 streams fp32 as the reference does.')
    parser.add_argument('--img-wire-pack', type=int, default=1,
                        help='transfer only image-PRESENT rows (uint8, '
                             'static capacity = the resolved '
                             '--img-pack-frac) and scatter to the dense '
                             'batch in-graph; overflow batches fall back '
                             'to the dense wire. Active on single-device '
                             'meshes with --img-wire-u8; bit-exact. '
                             '0 disables.')
    parser.add_argument('--eval-batch-cache-mb', type=int, default=2048,
                        help='byte budget (MB) for replaying assembled '
                             'eval batches across passes (per-epoch '
                             'validation; 3_test per-checkpoint walk). '
                             'Eval datasets are deterministic by contract '
                             '(cached index/window dicts, '
                             'dataset_new.py:833-894) so every pass '
                             'assembles identical batches; replay skips '
                             'the repeated host work. 0 disables.')
    return parser


@dataclasses.dataclass(frozen=True)
class Config:
    """Frozen snapshot of all flags + derived fields."""
    # everything from the parser lands here; see build_parser for semantics
    seed: int
    seed_list: Tuple[int, ...]
    device: Tuple[int, ...]
    cpu: int
    num_workers: int
    gpus: int
    reset: bool
    project_name: str
    checkpoint: bool
    flexconst: float
    prediction_range: int
    min_inputlen: int
    window_size: int
    vslt_type: str
    realtime: int
    multiimages: int
    tie_len: int
    ar_lowerbound: float
    ar_upperbound: float
    input_types: str
    output_type: str
    predict_type: str
    modality_inclusion: str
    fullmodal_definition: str
    train_data_path: str
    test_data_path: str
    dir_result: str
    image_data_path: str
    cross_fold_val: int
    val_data_ratio: float
    imgtxt_time: int
    missing_exhaustive: int
    epochs: int
    batch_size: int
    l2_coeff: float
    dropout: float
    activation: str
    optim: str
    lr_scheduler: str
    lr_init: float
    t_0: int
    t_mult: int
    t_up: int
    gamma: float
    momentum: float
    weight_decay: float
    patient_time: bool
    threshold: float
    output_dim: int
    txt_num_layers: int
    txt_dropout: float
    txt_model_dim: int
    txt_num_heads: int
    txt_classifier_nodes: int
    txt_tokenization: str
    berttype: str
    biobert_path: str
    character_token_max_length: int
    word_token_max_length: int
    bpe_token_max_length: int
    bert_token_max_length: int
    enc_depth: int
    hidden_size: int
    transformer_dim: int
    transformer_num_layers: int
    transformer_num_head: int
    resnet_num_layers: int
    vit_num_layers: int
    vit_patch_size: int
    img_model_type: str
    img_pretrain: str
    img_pretrain_path: Optional[str]
    image_size: int
    image_train_type: str
    image_test_type: str
    image_norm_type: str
    residual_bottlenecks: int
    mbt_bottlenecks_n: int
    mbt_fusion_startidx: int
    mbt_only_vslt: int
    model_types: str
    loss_types: str
    auxiliary_loss_input: Optional[str]
    auxiliary_loss_type: str
    auxiliary_loss_weight: float
    mandatory_vitalsign_labtest: Tuple[str, ...]
    vitalsign_labtest: Tuple[str, ...]
    model: str
    log_iter: int
    non_pat_neg_sample_n: int
    pat_neg_sample_n: int
    pat_pos_sample_n: int
    best: bool
    last: bool
    fuse_baseline: Optional[str]
    mmtm_ratio: float
    daft_activation: str
    fusion_type: str
    image_observed_prop: int
    text_observed_prop: int
    multitoken: int
    collate: int
    quantization: bool
    show_roc: bool
    usepe: bool
    # TPU-native
    precision: str
    use_pallas: int
    worker_type: str
    debug_nans: int
    dp_size: int
    mp_size: int
    dist_coordinator: str
    dist_num_processes: int
    dist_process_id: int
    remat: int
    prng: str
    ckpt_backend: str
    checkpoint_every: int
    profile_dir: Optional[str]
    resume: str
    img_pack: int
    img_pack_frac: float
    train_multi_k: int
    tie_buckets: str
    length_rebatch: int
    eval_length_rebatch: int
    image_cache_dir: str
    image_cache_mb: int
    eval_batch_cache_mb: int
    txt_device_table_mb: int
    img_wire_u8: int
    img_wire_pack: int
    # derived
    dir_root: str = "."
    log_fold: int = 0

    # ------------------------------------------------------------------
    @property
    def n_modality(self) -> int:
        return len(self.input_types.split("_"))

    @property
    def vslt_len(self) -> int:
        return len(self.vitalsign_labtest)

    @property
    def vslt_mask(self) -> List[bool]:
        """True = channel removed (data_preprocess.py:43)."""
        return [name not in self.vitalsign_labtest for name in constants.VITALSIGN_LABTEST]

    @property
    def feature_means(self) -> np.ndarray:
        """Population means restricted to selected channels
        (data_preprocess.py:83-84)."""
        return np.delete(constants.FEATURE_MEANS, np.where(self.vslt_mask)[0], axis=0)

    @property
    def feature_mins(self) -> np.ndarray:
        return constants.FEATURE_MINS

    @property
    def feature_maxs(self) -> np.ndarray:
        return constants.FEATURE_MAXS

    @property
    def txt_token_size(self) -> int:
        """Sequence length of the text modality entering the model."""
        if self.berttype == "biobert":
            return 128 if "embedding" in self.biobert_path else 1
        return {
            "word": self.word_token_max_length,
            "character": self.character_token_max_length,
            "bpe": self.bpe_token_max_length,
            "bert": self.bert_token_max_length,
        }[self.txt_tokenization]

    @property
    def token_max_length(self) -> int:
        """Feature dimension of a text token (768 for biobert embeddings)."""
        if self.berttype == "biobert":
            return 768
        return self.bert_token_max_length

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        """Cross-flag validation (reference config.py:157-159)."""
        if "train-full" in self.modality_inclusion:
            mods = [i for i in self.input_types.split("_") if i != "vslt"]
            defs = self.fullmodal_definition.split("_")
            if not all((m + "1") in defs for m in mods):
                raise ValueError(
                    'invalid input_types for full_modal with fullmodal_definition!!!')


_RENAMES = {
    "TIE_len": "tie_len",
    "mbt_fusion_startIdx": "mbt_fusion_startidx",
    "nonPatNegSampleN": "non_pat_neg_sample_n",
    "PatNegSampleN": "pat_neg_sample_n",
    "PatPosSampleN": "pat_pos_sample_n",
}


def native_lib_path() -> str:
    """Location of the built C++ TIE assembler (native/build.sh output);
    --worker-type auto resolves on its presence. Kept here (duplicating
    data/native.py::_LIB_PATH's target) so config never imports the data
    package."""
    return os.path.join(os.path.dirname(__file__), "..", "native",
                        "libtie_assembler.so")


def config_from_namespace(ns: argparse.Namespace) -> Config:
    d = vars(ns).copy()
    for old, new in _RENAMES.items():
        if old in d:
            d[new] = d.pop(old)
    for k in ("seed_list", "device", "mandatory_vitalsign_labtest", "vitalsign_labtest"):
        v = d.get(k)
        if isinstance(v, list):
            d[k] = tuple(v)
        elif isinstance(v, int):
            d[k] = (v,)
    if not d.get("dir_root"):
        d["dir_root"] = os.getcwd()
    if d.get("worker_type") == "auto":
        d["worker_type"] = ("native" if os.path.exists(native_lib_path())
                            else "thread")
    field_names = {f.name for f in dataclasses.fields(Config)}
    d = {k: v for k, v in d.items() if k in field_names}
    cfg = Config(**d)
    cfg.validate()
    return cfg


def parse_config(argv: Optional[List[str]] = None) -> Config:
    parser = build_parser()
    ns = parser.parse_args(argv)
    return config_from_namespace(ns)
