"""Distribution over ``torch.distributed``: the sharding rules
(``sharding``), the bucketed and int8 all-reduce (``collectives``) and the
sequence-parallel decode (``sp_decode``)."""
