"""utils: see the counterpart package os1_tpu/utils."""
