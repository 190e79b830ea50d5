"""View parallelism of the port: process groups, view sharding and sharded attention."""
