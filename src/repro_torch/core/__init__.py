"""The engine: seed, feature table, plan, IR, validation, emitters, apps."""
