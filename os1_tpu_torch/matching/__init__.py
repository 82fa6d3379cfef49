"""matching: see the counterpart package os1_tpu/matching."""
