"""Models of the port: the decoder LM (``layers``, ``chunked_attention``,
``attention`` with GQA and MLA, ``moe``, ``transformer``), ring attention
on the dynamic-pipeline runtime (``ring_attention``), and the recsys
embedding layer with AutoInt (``recsys``). The GNNs come with a later
slice (ROADMAP.md queue A item 6c)."""
