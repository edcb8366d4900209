"""Ray-sharded data parallelism over `torch.distributed`, table-row
sharding, and the tiny seeded problem its multi-process tests share."""
