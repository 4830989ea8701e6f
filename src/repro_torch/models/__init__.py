"""Models of the port: the decoder LM (``layers``, ``chunked_attention``,
``attention`` with GQA and MLA, ``moe``, ``transformer``) and the recsys
embedding layer with AutoInt (``recsys``). Ring attention and the GNNs come
with later slices (ROADMAP.md queue A items 6b and 6c)."""
