"""Training of the port, module for module the reference's ``repro/train``:
``optimizer`` (AdamW with float32 moments), ``compression`` (int8 gradients
with error feedback), ``checkpoint`` (``CheckpointManager``: atomic, async,
the reference's on-disk contract) and ``steps`` (the train and serve step
builders)."""
