"""The plain reference the port is judged against: a frozen plain copy of
the model code (``plain/``) and the reference runs of each traffic kind.
Imports neither JAX, nor ``upcc_tpu``, nor ``upcc_tpu_torch``."""
