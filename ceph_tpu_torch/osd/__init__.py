"""OSD-side host layer of the port: the stripe geometry (``ecutil``), the
core types, placement on the host (``osdmap``, ``map_codec``,
``map_inc``), the OSD's wire messages (``messages``), the PG log
(``pglog``), the EC and replicated backends (``backend``), the windowed
recovery engine (``recovery``), the PG (``pg``) with its hit sets
(``hitset``), its scrub engine (``scrub``) and its object classes
(``cls``).  The daemon comes in a later slice."""
