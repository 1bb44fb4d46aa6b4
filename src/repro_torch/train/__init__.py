"""Training-side infrastructure of the port: checkpoints (:mod:`.checkpoint`)."""
