"""Device-resident BioBERT embedding table (the H2D wire format; the
port's own copy of ``medical_tri_modal_pilot_tpu/data/txt_table.py``).

The reference streams each stay's full (128, 768) fp32 note embedding to
the device inside every batch (dataset_new.py:740-781 loads it per
``__getitem__``; the torch DataLoader collates and ships it): 25 MB of a
40 MB batch at B=64. The embeddings are static per note, so the table of
every unique embedding goes to the device once at startup, batches carry
an int32 row id per sample (256 B/batch), and the Trainer gathers the
rows on the device (``Trainer.resolve_wire``).

Semantics are bit-identical to streaming: row 0 is all-zero (what
``fetch_text`` emits for missing text via ``zero_array``) and every other
row is exactly the padded array fetch_text would have produced
(``text.fetch_text_id`` mirrors its gates). Capacity-gated by
``--txt-device-table-mb`` (0 disables): corpora whose unique-note table
exceeds the budget fall back to streaming dense txt unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import numpy as np

from ..config import Config
from .text import BioBertStore


@dataclass
class TxtTable:
    """rows[0] is all-zero; rows_by_text maps a stripped note text to its
    row index; lengths[i] is the pre-pad token count fetch_text reports."""
    rows: np.ndarray                       # [N, txt_token_size, 768] fp32
    lengths: np.ndarray                    # [N] int32
    rows_by_text: Dict[str, int] = field(default_factory=dict)

    @property
    def nbytes(self) -> int:
        return self.rows.nbytes

    def densify(self, batch: dict) -> dict:
        """Host-side resolution of a wire batch (txt_id -> txt rows,
        uint8 img -> fp32/255) — the exact arrays the streaming path
        would have produced. Used for model init and for tests."""
        out = dict(batch)
        if "txt_id" in out:
            out["txt"] = self.rows[np.asarray(out.pop("txt_id"))]
        img = out.get("img")
        if img is not None and img.dtype == np.uint8:
            out["img"] = img.astype(np.float32) / 255.0
        return out


def build_txt_table(cfg: Config, datasets: Sequence) -> Optional[TxtTable]:
    """Build the unique-note embedding table over the given datasets'
    indices and attach it to each (``ds.set_txt_table``). Returns None —
    leaving every dataset in streaming mode — when the biobert+bert
    embedding path is not active, the store is absent, any embedding is
    1-D (the txt_token_size == 1 vector contract), or the table would
    exceed ``--txt-device-table-mb``.

    Iteration order is the datasets' index order, which is deterministic
    and identical across multi-host processes (parallel/distributed
    contract), so every host builds the same table."""
    if not (cfg.berttype == "biobert" and cfg.txt_tokenization == "bert"
            and cfg.txt_token_size > 1
            and getattr(cfg, "txt_device_table_mb", 0) > 0):
        return None
    store = BioBertStore(cfg.biobert_path)
    if not store.available():
        return None
    S, D = cfg.txt_token_size, cfg.token_max_length
    budget = cfg.txt_device_table_mb * 2 ** 20
    row_bytes = S * D * 4
    rows = [np.zeros((S, D), np.float32)]
    lengths = [0]
    rows_by_text: Dict[str, int] = {}
    for ds in datasets:
        for s in ds.index.samples:
            if "txt1" not in s.file_name:
                continue
            raw = ds.cache.get(s.pkl_path)
            text = raw["txt_input"][0].strip()
            if len(text) == 0 or text in rows_by_text:
                continue
            emb = store.lookup(text)
            if emb is None:
                continue
            if emb.ndim == 1:
                return None   # vector contract — streaming handles it
            if (len(rows) + 1) * row_bytes > budget:
                return None   # over budget: stream dense txt instead
            out = np.zeros((S, D), np.float32)
            out[:emb.shape[0]] = emb
            rows_by_text[text] = len(rows)
            lengths.append(emb.shape[0])
            rows.append(out)
    table = TxtTable(rows=np.stack(rows), lengths=np.asarray(lengths, np.int32),
                     rows_by_text=rows_by_text)
    for ds in datasets:
        ds.set_txt_table(table)
    return table
