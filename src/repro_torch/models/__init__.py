"""Models of the port: the decoder LM (``layers``, ``chunked_attention``,
``attention`` with GQA and MLA, ``moe``, ``transformer``), ring attention
on the dynamic-pipeline runtime (``ring_attention``), and the recsys
embedding layer with AutoInt (``recsys``), and the GNNs (``gnn``: GIN,
GraphCast, DimeNet, MACE on one device, and their partitioned losses on a
ring mesh, ``gnn.distributed``)."""
