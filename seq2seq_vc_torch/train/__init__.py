"""Training (mirrors seq2seq_vc_tpu/train): the AAS-VC trainer, its
optimizer, schedule, state and data pipeline."""
