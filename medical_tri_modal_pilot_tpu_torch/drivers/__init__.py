"""The port's train and test drivers, counterparts of ``2_train.py`` and
``3_test.py`` with the same flags:

    python -m medical_tri_modal_pilot_tpu_torch.drivers.train <flags>
    python -m medical_tri_modal_pilot_tpu_torch.drivers.test <flags>
"""
