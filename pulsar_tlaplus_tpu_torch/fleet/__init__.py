"""Fleet tier: N checker daemons behind one dispatcher — the port's copy
of ``pulsar_tlaplus_tpu/fleet/``.

One daemon (``service/``) time-slices one card.  A dispatcher daemon
(``cli.py dispatch``, :mod:`fleet.dispatcher`) fronts several ``serve``
daemons behind one authenticated endpoint speaking the SAME wire
protocol, so clients are unchanged.  Three mechanisms:

- **Routing** (:mod:`fleet.registry`): a health loop polls each
  backend's ``ping``/``metrics`` verbs and places submits by the live
  ``ptt_*`` signal (queue depth, active-job load, admission sheds), with
  per-tenant stickiness only while warm locality pays.
- **Replication** (:mod:`fleet.replicate`): on job completion the
  owning daemon's warm artifact is offered to peers through a sieve
  handshake — manifest digests first, ship only the blobs a peer is
  missing, each delta-compressed with the plane codec
  (``store/compress.py``) — so a resubmit landing on ANY backend
  warm-starts.
- **Failover**: a backend that stops answering is drained from routing;
  its queued (not running) jobs are resubmitted elsewhere through the
  idempotent ``submit_id`` dedup path, its running jobs are typed
  ``lost`` and reconciled to their real result if it rejoins.

The dispatcher touches no device.  The fleet reaches the card through
its backends: each is a ``serve`` daemon whose jobs run on its device
slots (``ServiceConfig.devices``; slot i on ``cuda:i``).  Nothing here
imports the JAX package.
"""
