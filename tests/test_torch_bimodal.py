"""The flagship's bimodal aliases in the port against the JAX package on
the CPU: ``bitxt_mbt_vsltcls`` and ``biimg_mbt_vsltcls``, which both
registries map to the flagship class (JAX registry.py:40-41), one eval
step each over missing_num 0 and 1 with the weights carried across
(small MBT width, the full Swin-T for the image model)."""
import pytest

from test_torch_mbt_v1 import check_model_eval
from test_torch_unimodal import SMALL


@pytest.mark.parametrize("inputs", ["vslt_txt", "vslt_img"])
def test_bimodal_alias_eval_step_matches_jax(inputs):
    model = "bitxt_mbt_vsltcls" if inputs == "vslt_txt" else \
        "biimg_mbt_vsltcls"
    check_model_eval(SMALL + ["--model", model, "--input-types", inputs,
                              "--imgtxt-time", "1"], bridge=False)
