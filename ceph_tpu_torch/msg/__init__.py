"""Wire layer (L2): typed messages + async messenger.

Reference roles: Messenger/Dispatcher/Message (src/msg/Messenger.h,
src/msg/Dispatcher.h, src/msg/Message.h) and the AsyncMessenger event
loop with ordered lossless sessions (src/msg/async/AsyncConnection.h:49
state machine, src/msg/async/Event.h:87 EventCenter).  The transport
is asyncio TCP (one loop thread per messenger); this layer carries
control messages and host-resident data.

Port of ``ceph_tpu/msg/``; its frames are the reference's byte for byte.
"""

from ceph_tpu_torch.msg.message import Message, EntityName, register  # noqa: F401
from ceph_tpu_torch.msg.messenger import Connection, Dispatcher, Messenger  # noqa: F401
