"""Launch helpers: meshes (``mesh``).  The dry run, roofline and report of
the reference's ``launch/`` are not ported yet."""
