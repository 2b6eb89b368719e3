"""Launch: meshes (``mesh``), meta-tensor input specs (``specs``), the
multi-pod dry run (``dryrun``), its roofline terms (``roofline``) and
tables (``report``)."""
