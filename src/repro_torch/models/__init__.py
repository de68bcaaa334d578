"""The LM zoo: the ten architectures of ``configs/archs.py`` (dense, MoE,
hybrid RG-LRU, Mamba2 SSD, enc-dec, VLM), training, prefill and decode.

Plain functions on ``NamedTuple`` parameter structures, as in
``repro.models``: each pattern slot's layers are stacked ``(num_blocks,
...)``, so the reference's weights and decode states map onto the port's
key for key (``convert.py``).
"""
