"""Device runtime of the port: the stripe-batch queue, its staging
pool, and the covering-bucket rule for batch widths (the counterpart of
``ceph_tpu/tpu/``)."""
