"""Library sharding over a mesh of torch devices (the port of
`ann_solo_tpu/parallel/`): `mesh` builds the meshes, `sharded` the masked
top-k and k-means steps, `sharded_ivf` the list-sharded IVF index."""
