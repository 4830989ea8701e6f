"""Models of the port: the decoder LM (``layers``, ``chunked_attention``,
``attention`` with GQA and MLA, ``moe``, ``transformer``), ring attention
on the dynamic-pipeline runtime (``ring_attention``), and the recsys
embedding layer with AutoInt (``recsys``), and the single-device GNNs
(``gnn``: GIN, GraphCast, DimeNet, MACE; their partitioned losses are
ROADMAP.md queue A item 6c-ii)."""
