"""Plain PyTorch counterparts of the reference ops the serving slice runs
(``paddle_tpu/ops``): computed by PyTorch itself, as XLA computed them
outside any Pallas kernel."""
