"""OSD-side geometry of the port (the OSD itself comes in a later
slice)."""
