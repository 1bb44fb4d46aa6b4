"""The port's distributed paths over ``torch.distributed``: process
groups (:mod:`.world`), graph sharding and multi-process extraction
(:mod:`.sharding`), and int8 compressed collectives (:mod:`.compression`)."""
