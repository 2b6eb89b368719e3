"""Distribution over ``torch.distributed``: the sharding rules
(``sharding``), the bucketed and int8 all-reduce (``collectives``), the
sequence-parallel decode (``sp_decode``) and the tensor/expert parallel
collectives of the split models (``tensor_parallel``)."""
