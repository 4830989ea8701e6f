"""GNN substrate of the port. Only the MLP of ``common`` is here, for
AutoInt's head; the message-passing models come with the GNN slice
(ROADMAP.md queue A item 6c)."""
