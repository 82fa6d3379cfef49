"""ops: see the counterpart package os1_tpu/ops."""
