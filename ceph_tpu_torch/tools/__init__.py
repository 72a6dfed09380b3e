"""Command-line tools of the port: ``ecbench`` (the device EC engine
bench), ``crushtool``, ``osdmaptool``, ``dencoder``, the cluster CLIs
``rados``, ``ceph`` and ``rados_bench``, the offline store tools
``objectstore_tool`` and ``monstore_tool``, and ``cephtop``."""
