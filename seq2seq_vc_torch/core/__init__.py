"""core of the PyTorch port (mirrors seq2seq_vc_tpu/core): the config system."""
