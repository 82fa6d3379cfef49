"""features: see the counterpart package os1_tpu/features."""
