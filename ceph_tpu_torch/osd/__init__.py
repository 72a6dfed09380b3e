"""OSD-side host layer of the port: the stripe geometry (``ecutil``), the
core types, placement on the host (``osdmap``, ``map_codec``,
``map_inc``), the OSD's wire messages (``messages``) and the PG log
(``pglog``).  The EC backend, the PG and the daemon come in later
slices."""
