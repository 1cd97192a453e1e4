"""Work taxonomy of the priority scheduler (reference: ``beacon_node/beacon_processor``).

Only ``work.py`` is here so far: the device runtime needs its
``RequeueWork`` and ``STANDARD_DEVICE_BATCH``.  The processor and the
admission controller come with the host node.
"""
