"""Model families: parameter layout, seeded weights, the package's model and the reference's, multiply-adds."""
