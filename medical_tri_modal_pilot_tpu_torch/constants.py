"""Dataset-wide constants shared by the data pipeline and models.

The port's own copy of ``medical_tri_modal_pilot_tpu/constants.py``.

Mirrors the reference's hard-coded feature vocabulary and normalization
constants (reference: builder/data/dataset_new.py:32-40,
builder/data/data_preprocess.py:80-84, builder/utils/utils.py:13-38).
"""
from __future__ import annotations

import numpy as np

# The 18 vital-sign / lab-test channel names as they appear in pkl
# ``feature_order`` metadata (reference: dataset_new.py:32-34).
VITALSIGN_LABTEST = [
    'HR', 'RR', 'BT', 'SBP', 'DBP', 'Sat', 'GCS',
    'Hematocrit', 'PLT', 'WBC', 'Bilirubin', 'pH', 'HCO3',
    'Creatinine', 'Lactate', 'Potassium', 'Sodium', 'CRP',
]

FEATURE_TYPES = [
    'PULSE', 'RESP', 'TEMP', 'SBP', 'DBP', 'SpO2', 'GCS',
    'HEMATOCRIT', 'PLATELET', 'WBC', 'BILIRUBIN', 'pH', 'HCO3',
    'CREATININE', 'LACTATE', 'POTASSIUM', 'SODIUM', 'CRP',
]

# Population means from the reference training set (dataset_new.py:40).
FEATURE_MEANS = np.array([
    85.93695802, 20.10544135, 36.97378611, 120.00165406, 62.85878326,
    96.7560417, 14.58784295, 29.44163972, 200.15499694, 12.11825286,
    3.79762327, 7.37816261, 24.38824869, 1.5577265, 2.51239096,
    4.12411448, 138.91951009, 88.96706267,
], dtype=np.float64)

# Hard-coded min/max normalization constants
# (reference: data_preprocess.py:80-82).
FEATURE_MINS = np.array([
    0.0, 0.0, 25.0, 0.0, 0.0, 0.0, 9.0, 0.0, 5.0,
    0.0, 0.0, 0.94, 2.0, 0.0, 0.0, 0.8, 67.0, 0.2,
], dtype=np.float64)

FEATURE_MAXS = np.array([
    295.0, 120.0, 43.05555555556, 299.0, 298.0, 100.0, 15.0, 68.6, 1000.0,
    100.0, 75.0, 9.38, 50.0, 20.0, 20.0, 14.7, 185.0, 531.3,
], dtype=np.float64)

FEATURE_MAX_MINS = FEATURE_MAXS - FEATURE_MINS

N_FEATURES = 18

# UMSE feature-id vocabulary: ids 0..17 are vslt channels, 18 = image
# modality token, 19 = text modality token (reference:
# tri_mbt_vsltcls.py:160-165 img_feat=18, txt_feat=19; ie_feat=Embedding(20,d)).
IMG_FEATURE_ID = 18
TXT_FEATURE_ID = 19
N_FEATURE_IDS = 20

# Attention mask fill value — fp16-safe minimum, preserved for numerical
# parity (reference: attention.py:38 masked_fill_(mask, -65504)).
MASK_FILL_VALUE = -65504.0
