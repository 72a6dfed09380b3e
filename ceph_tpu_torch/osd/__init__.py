"""OSD-side host layer of the port: the stripe geometry (``ecutil``),
the core types, and placement on the host (``osdmap``, ``map_codec``,
``map_inc``); the OSD itself comes in a later slice."""
