"""Feature encoders of the PyTorch port (mirrors seq2seq_vc_tpu/encoders):
``ppg`` (the ``ppg_sxliu`` conformer upstream and s3prl featurizer) and
``encodec`` (EnCodec-24kHz's SEANet encoder and decoder)."""
