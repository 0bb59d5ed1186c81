"""Distribution layer of the port: gradient compression. Sharding and
expert parallelism come with ROADMAP A14."""
