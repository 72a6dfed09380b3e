"""Device runtime of the port: the stripe-batch queue, its staging
pool, the covering-bucket rule for batch widths, and the device watch
(the counterpart of ``ceph_tpu/tpu/``)."""
