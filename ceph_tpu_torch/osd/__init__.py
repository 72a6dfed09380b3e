"""OSD-side host layer of the port: the stripe geometry (``ecutil``), the
core types, placement on the host (``osdmap``, ``map_codec``,
``map_inc``), the OSD's wire messages (``messages``), the PG log
(``pglog``), the EC and replicated backends (``backend``) and the
windowed recovery engine (``recovery``).  The PG and the daemon come in
later slices."""
