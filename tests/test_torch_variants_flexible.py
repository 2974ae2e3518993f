"""``tri_mbt_vflexible2`` and ``tri_mbt_vflexible3`` (the masked weights
scaled by 10 and 3.334 after the -1e9 fill, softmaxed in fp32) against
the JAX package: tests/test_torch_variants.py's ``check_model`` (eval
within 1e-5; one train step: loss 1e-5, parameters and Adam moments at
compare_train_state's bounds). Their LayerNorm head holds no running
statistics."""
import pytest

from medical_tri_modal_pilot_tpu_torch.config import parse_config
from test_torch_mbt_v1 import batch_for
from test_torch_variants import argv_for, check_model


@pytest.mark.parametrize("name,temp", [("tri_mbt_vflexible2", 10.0),
                                       ("tri_mbt_vflexible3", 3.334)])
def test_vflexible_temperature_matches_jax(name, temp):
    argv = argv_for(name)
    tr = check_model(argv, batch_for(parse_config(argv)))
    assert tr.model.flex_temp == temp
