"""``biimg_mt_v1`` and ``mt_v1`` (the concat fusion on vslt+img, and the
reference's dead ``mt_v1`` mapped to the tri-modal core, as in the JAX
registry) end to end against the JAX package through
tests/test_torch_variants.py's ``check_model`` (eval within 1e-5; one
train step: loss 1e-5, parameters, Adam moments and running statistics at
compare_train_state's bounds), and the trunk of every name of this slice
that has images: packed (the MBT ablations) or over every row (the
concat fusion), frozen at --img-pretrain Yes only."""
import pytest

from medical_tri_modal_pilot_tpu_torch.config import parse_config
from medical_tri_modal_pilot_tpu_torch.models import get_model
from test_torch_mbt_v1 import batch_for
from test_torch_variants import NAMES, SMALL, argv_for, check_model


@pytest.mark.parametrize("name", ["biimg_mt_v1", "mt_v1"])
def test_mt_image_models_match_jax(name):
    argv = argv_for(name)
    tr = check_model(argv, batch_for(parse_config(argv)))
    assert tr.model.trunk_rows == 4


def test_wiring_of_the_new_names():
    """The MBT ablations pack the frozen trunk as the flagship does, the
    concat fusion runs it over every row; each freezes its trunk at
    --img-pretrain Yes only (JAX registry.py:98-118): at No the trunk
    trains (training mode under model.train(), unpacked). The heads per
    stream and the flexible weights take three streams."""
    for name, inputs in NAMES.items():
        if inputs == "vslt_txt" or name.endswith("vflexible1"):
            continue
        cfg = parse_config(argv_for(name, "--img-pack", "-1"))
        model = get_model(cfg)
        assert model.frozen and model.img_pack == ("mt_v1" not in name)
        cfg = parse_config(argv_for(name, "--img-pretrain", "No"))
        model = get_model(cfg)
        assert not model.frozen and not model.img_pack
        assert model.train().img_encoder.training
    for name in ("tri_mbt_vnoshavgtr", "tri_mbt_vflexible2"):
        with pytest.raises(ValueError, match="vslt_img_txt|Queue 3"):
            get_model(parse_config(SMALL + ["--model", name,
                                            "--input-types", "vslt_txt"]))
