"""The multitoken models over the VSLTMAIN fusion, ``tri_mbt_vmulti2`` and
``tri_mbt_vmultivslt``, end to end in the port against the JAX package on
the CPU (tests/test_torch_multitoken.py::check_multitoken_model: the
[4, B] logits, the selected probabilities and loss, one train step at
dropout 0, from perturbed JAX weights carried across). A file of its own
so that each file stays near a minute of one test worker."""
import pytest

from test_torch_multitoken import check_multitoken_model


@pytest.mark.parametrize("model", ["tri_mbt_vmulti2", "tri_mbt_vmultivslt"])
def test_vsltmain_model_matches_jax(model):
    check_multitoken_model(model)
