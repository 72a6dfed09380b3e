"""CRUSH placement on PyTorch and CUDA.

The port of ``ceph_tpu/crush``: rjenkins hashes (``hashes``), the
fixed-point crush_ln (``ln``, ``ln_table``), the map and its flattened
device image (``map``), the text compiler (``compiler``), and the rule
walk with its staged sweeps (``mapper``), whose kernel is
``csrc/crush.cu`` (``ops/crush_rule.py``).  Bit-exactness with Ceph's
mapper.c is the contract, as in the reference.
"""
