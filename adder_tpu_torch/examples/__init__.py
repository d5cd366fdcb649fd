"""User examples of adder_tpu_torch, the port's twins of the JAX package's
`examples/frames_to_adder.py` and `examples/events_to_instantaneous_frames.py`,
each run as `python -m adder_tpu_torch.examples.<name>`. The JAX package's
kernel profilers have no twin here: `chip_smoke.py` times the port's
kernels."""
