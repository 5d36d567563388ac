"""The solvers a traffic mix calls, one module each, named by the mix's
`method`: how a solve is called, drawn, checked and compared."""
