"""io: see the counterpart package os1_tpu/io."""
