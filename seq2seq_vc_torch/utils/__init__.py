"""utils of the PyTorch port (mirrors seq2seq_vc_tpu/utils): wav, HDF5 and
statistics I/O, teacher durations."""
