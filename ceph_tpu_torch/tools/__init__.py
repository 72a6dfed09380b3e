"""Command-line tools of the port: ``ecbench`` (the device EC engine
bench), ``crushtool``, ``osdmaptool`` and ``dencoder``."""
