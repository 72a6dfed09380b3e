"""Cluster control plane: the monitor's wire messages.

Port of ``ceph_tpu/mon/``'s ``messages`` module (reference: src/mon/ and
src/messages/).  The monitor itself (``Monitor``, ``MonMap``, Paxos,
election) and ``MonClient`` come with the daemon and client slices
(ROADMAP queue 1 items 1i and 1j), so this package imports neither yet.
"""
