"""solvers: see the counterpart package os1_tpu/solvers."""
