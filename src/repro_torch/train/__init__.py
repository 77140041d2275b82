"""Approximate training: AdamW, the OASRS-weighted train step, straggler
reweighting and checkpoints (the reference's ``train/``)."""
