"""dsp of the PyTorch port (mirrors seq2seq_vc_tpu/dsp)."""
