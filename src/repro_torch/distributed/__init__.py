"""Fault tolerance of the training loop (``ft.py``, the counterpart of
``repro.distributed.ft``). Mesh sharding and collectives are not ported."""
