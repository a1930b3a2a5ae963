"""Device meshes for the sharded checker (:mod:`.mesh`)."""
