"""geometry: see the counterpart package os1_tpu/geometry."""
