"""Models of the port: the dense decoder LM (``layers``,
``chunked_attention``, ``attention``, ``transformer``) and the recsys
embedding layer with AutoInt (``recsys``). MLA, MoE, ring attention and the
GNNs come with later slices (ROADMAP.md queue A item 6)."""
