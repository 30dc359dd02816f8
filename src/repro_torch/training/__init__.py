"""Training on one card: the synthetic data stream, AdamW, the train step
with microbatch accumulation, and the ``train_lm`` driver (counterparts of
``repro.training`` and ``examples/train_lm.py``)."""
