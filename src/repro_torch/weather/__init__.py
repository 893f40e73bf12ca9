"""repro_torch.weather: state, plain dycore pieces, the op registry and plans."""
